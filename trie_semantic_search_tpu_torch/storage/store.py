"""Persistent case storage (copy of ``trie_semantic_search_tpu/storage/
store.py``): sqlite with two tables, case metadata as JSON plus indexed
court and date columns, and case text as gzip blobs. The schema and the
encodings are the JAX package's, so either package reads a database the
other wrote; dense row ids follow sqlite's rowid order
(:meth:`StorageManager.fetch_filter_columns`). The serving side, the batch
write, the index build's iteration (``iter_cases``, ``iter_cases_rowid``),
the lookups and deletes the server and the ingest dedup call
(``find_case_id``, ``case_exists``, ``delete_case``) and timed backups
with retention (``create_backup``).
"""

from __future__ import annotations

import gzip
import json
import logging
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Sequence

from ..core.config import StorageConfig
from ..core.metrics import metrics
from ..core.errors import (
    DatabaseConnectionFailed,
    DatabaseError,
    SerializationFailed,
    StorageCorruption,
)
from ..core.types import CaseId, CaseMetadata

_log = logging.getLogger("tss_torch.storage")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS case_metadata (
    case_id TEXT PRIMARY KEY,
    name TEXT NOT NULL,
    citation TEXT,
    court TEXT,
    decision_date TEXT,          -- ISO date, sortable
    metadata_json TEXT NOT NULL  -- full CaseMetadata (minus full_text)
);
CREATE INDEX IF NOT EXISTS idx_meta_court ON case_metadata(court);
CREATE INDEX IF NOT EXISTS idx_meta_date ON case_metadata(decision_date);
CREATE TABLE IF NOT EXISTS case_text (
    case_id TEXT PRIMARY KEY,
    compressed INTEGER NOT NULL,
    text BLOB NOT NULL
);
"""


# Upserts (NOT "INSERT OR REPLACE", which delete+reinserts and assigns a NEW
# rowid): fetch_filter_columns orders by rowid and promises dense row ids
# stable under append, so rewrites (e.g. the reprocess job) must preserve
# each case's rowid.
UPSERT_METADATA = (
    "INSERT INTO case_metadata "
    "(case_id, name, citation, court, decision_date, metadata_json) "
    "VALUES (?, ?, ?, ?, ?, ?) "
    "ON CONFLICT(case_id) DO UPDATE SET "
    "name=excluded.name, citation=excluded.citation, "
    "court=excluded.court, decision_date=excluded.decision_date, "
    "metadata_json=excluded.metadata_json"
)
UPSERT_TEXT = (
    "INSERT INTO case_text (case_id, compressed, text) "
    "VALUES (?, ?, ?) "
    "ON CONFLICT(case_id) DO UPDATE SET "
    "compressed=excluded.compressed, text=excluded.text"
)


def metadata_row(metadata: CaseMetadata) -> tuple:
    """The :data:`UPSERT_METADATA` parameters of ``metadata``: its indexed
    columns and its JSON without ``full_text`` (text lives in its own
    table)."""
    doc = metadata.to_json()
    doc.pop("full_text", None)
    return (
        str(metadata.id),
        metadata.name,
        metadata.citation,
        metadata.court,
        metadata.decision_date.isoformat(),
        json.dumps(doc),
    )


def text_row(case_id: CaseId, text: str, compress: bool) -> tuple:
    """The :data:`UPSERT_TEXT` parameters of a case's text: gzip'd when
    ``compress``."""
    raw = text.encode("utf-8")
    return (str(case_id), 1 if compress else 0, gzip.compress(raw) if compress else raw)


@dataclass(slots=True)
class StorageStats:
    """ref: ``StorageStats`` fields surfaced by get_stats (storage.rs:37-43,
    295-314)."""

    total_cases: int = 0
    total_metadata_entries: int = 0
    total_text_entries: int = 0
    db_size_bytes: int = 0
    compression_enabled: bool = True


class StorageManager:
    """Case metadata + text store (ref: ``StorageManager``,
    storage.rs:28-377)."""

    def __init__(self, config: Optional[StorageConfig] = None):
        self.config = config or StorageConfig()
        self._lock = threading.RLock()
        db_path = self.config.db_path
        if self.config.db_type == "memory":
            db_path = ":memory:"
        else:
            Path(db_path).parent.mkdir(parents=True, exist_ok=True)
        try:
            self._conn = sqlite3.connect(db_path, check_same_thread=False)
            self._conn.executescript(_SCHEMA)
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.commit()
        except sqlite3.Error as e:
            raise DatabaseConnectionFailed(db_path=str(db_path), reason=str(e)) from e
        self._db_path = db_path

    # -- metadata CRUD (ref: storage.rs:99-232) -----------------------------

    def store_case_metadata(self, metadata: CaseMetadata) -> None:
        try:
            row = metadata_row(metadata)
        except (TypeError, ValueError) as e:
            raise SerializationFailed(data_type="CaseMetadata", reason=str(e)) from e
        with self._lock:
            try:
                self._conn.execute(UPSERT_METADATA, row)
                self._conn.commit()
            except sqlite3.Error as e:
                raise DatabaseError(str(e)) from e

    def get_case_metadata(self, case_id: CaseId) -> Optional[CaseMetadata]:
        with self._lock:
            row = self._conn.execute(
                "SELECT metadata_json FROM case_metadata WHERE case_id = ?",
                (str(case_id),),
            ).fetchone()
        if row is None:
            return None
        try:
            return CaseMetadata.from_json(json.loads(row[0]))
        except (ValueError, KeyError) as e:
            raise StorageCorruption(
                location=f"case_metadata/{case_id}", details=str(e)
            ) from e

    def get_case_metadata_many(
        self, case_ids: "Sequence[CaseId]"
    ) -> dict[str, CaseMetadata]:
        """Batch :meth:`get_case_metadata`: ONE ``IN (...)`` select for a
        whole serving batch's result rows (the per-row call costs ~80 µs
        of sqlite round trip each — round-5 profile: hydration is the
        serving bottleneck on the 1-core host). Returns {str(id): meta};
        missing ids are absent."""
        ids = [str(c) for c in case_ids]
        if not ids:
            return {}
        out: dict[str, CaseMetadata] = {}
        with self._lock:
            for lo in range(0, len(ids), 512):  # sqlite var limit safety
                chunk = ids[lo : lo + 512]
                rows = self._conn.execute(
                    "SELECT case_id, metadata_json FROM case_metadata "
                    f"WHERE case_id IN ({','.join('?' * len(chunk))})",
                    chunk,
                ).fetchall()
                for cid, payload in rows:
                    try:
                        out[cid] = CaseMetadata.from_json(json.loads(payload))
                    except (ValueError, KeyError) as e:
                        raise StorageCorruption(
                            location=f"case_metadata/{cid}", details=str(e)
                        ) from e
        return out

    def get_case_texts_many(
        self, case_ids: "Sequence[CaseId]"
    ) -> dict[str, str]:
        """Batch :meth:`get_case_text` (see ``get_case_metadata_many``). The
        decompress and decode of every row are summed into one
        ``store.gunzip`` sample."""
        ids = [str(c) for c in case_ids]
        if not ids:
            return {}
        out: dict[str, str] = {}
        unzip_s = 0.0
        with self._lock:
            for lo in range(0, len(ids), 512):
                chunk = ids[lo : lo + 512]
                rows = self._conn.execute(
                    "SELECT case_id, compressed, text FROM case_text "
                    f"WHERE case_id IN ({','.join('?' * len(chunk))})",
                    chunk,
                ).fetchall()
                for cid, compressed, blob in rows:
                    t0 = time.perf_counter()
                    try:
                        raw = gzip.decompress(blob) if compressed else blob
                        out[cid] = raw.decode("utf-8")
                    except (OSError, UnicodeDecodeError) as e:
                        raise StorageCorruption(
                            location=f"case_text/{cid}", details=str(e)
                        ) from e
                    unzip_s += time.perf_counter() - t0
        metrics.histogram("store.gunzip").observe(unzip_s * 1000)
        return out

    def store_case_text(self, case_id: CaseId, text: str) -> None:
        row = text_row(case_id, text, self.config.enable_compression)
        with self._lock:
            try:
                self._conn.execute(UPSERT_TEXT, row)
                self._conn.commit()
            except sqlite3.Error as e:
                raise DatabaseError(str(e)) from e

    def get_case_text(self, case_id: CaseId) -> Optional[str]:
        with self._lock:
            row = self._conn.execute(
                "SELECT compressed, text FROM case_text WHERE case_id = ?",
                (str(case_id),),
            ).fetchone()
        if row is None:
            return None
        compressed, blob = row
        t0 = time.perf_counter()
        try:
            raw = gzip.decompress(blob) if compressed else blob
            text = raw.decode("utf-8")
        except (OSError, UnicodeDecodeError) as e:
            raise StorageCorruption(
                location=f"case_text/{case_id}", details=str(e)
            ) from e
        metrics.histogram("store.gunzip").observe((time.perf_counter() - t0) * 1000)
        return text

    def list_case_ids(self) -> list[CaseId]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT case_id FROM case_metadata ORDER BY case_id"
            ).fetchall()
        return [uuid.UUID(r[0]) for r in rows]

    def find_case_id(self, name: str, citation: str) -> Optional[CaseId]:
        """The id of the stored case with this name and citation (the
        ingest dedup key: a re-fetched case gets a fresh UUID)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT case_id FROM case_metadata WHERE name = ? AND citation = ?",
                (name, citation),
            ).fetchone()
        return uuid.UUID(row[0]) if row else None

    def case_exists(self, case_id: CaseId) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM case_metadata WHERE case_id = ?", (str(case_id),)
            ).fetchone()
        return row is not None

    def delete_case(self, case_id: CaseId) -> bool:
        """Delete a case's metadata and text; True when it was stored."""
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM case_metadata WHERE case_id = ?", (str(case_id),)
            )
            self._conn.execute("DELETE FROM case_text WHERE case_id = ?", (str(case_id),))
            self._conn.commit()
        return cur.rowcount > 0

    def store_cases_batch(
        self, cases: Sequence[tuple[CaseMetadata, str]]
    ) -> tuple[int, list[tuple[CaseId, str]]]:
        """Batch store with per-item error tolerance + flush
        (ref: storage.rs:234-262). Returns (stored_count, [(id, error)])."""
        stored = 0
        errors: list[tuple[CaseId, str]] = []
        for metadata, text in cases:
            try:
                self.store_case_metadata(metadata)
                self.store_case_text(metadata.id, text)
                stored += 1
            except Exception as e:  # tolerate individual failures, keep going
                _log.warning("batch store failed for %s: %s", metadata.id, e)
                errors.append((metadata.id, str(e)))
        self.flush()
        return stored, errors

    # -- iteration helpers for index builds ---------------------------------

    def iter_cases(self) -> Iterator[tuple[CaseMetadata, str]]:
        """Stream (metadata, full_text) pairs in case-id order."""
        for case_id in self.list_case_ids():
            meta = self.get_case_metadata(case_id)
            if meta is None:
                continue
            yield meta, self.get_case_text(case_id) or ""

    def iter_cases_rowid(
        self, start_row: int = 0, batch: int = 256
    ) -> Iterator[tuple[int, CaseMetadata, str]]:
        """Stream ``(dense_row, metadata, full_text)`` in rowid order, the
        order of :meth:`fetch_filter_columns`, so the yielded index is the
        dense device row id. ``start_row`` skips rows already processed.
        Reads in bounded batches (keyset pagination on rowid)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT rowid FROM case_metadata ORDER BY rowid LIMIT 1 OFFSET ?",
                (start_row,),
            ).fetchone()
        if row is None:
            return
        last_rowid = row[0] - 1
        dense = start_row
        while True:
            with self._lock:
                rows = self._conn.execute(
                    "SELECT m.rowid, m.metadata_json, t.compressed, t.text "
                    "FROM case_metadata m "
                    "LEFT JOIN case_text t ON t.case_id = m.case_id "
                    "WHERE m.rowid > ? ORDER BY m.rowid LIMIT ?",
                    (last_rowid, batch),
                ).fetchall()
            if not rows:
                return
            for rowid, meta_json, compressed, blob in rows:
                last_rowid = rowid
                try:
                    meta = CaseMetadata.from_json(json.loads(meta_json))
                except (ValueError, KeyError) as e:
                    raise StorageCorruption(
                        location=f"case_metadata/rowid={rowid}", details=str(e)
                    ) from e
                text = ""
                if blob is not None:
                    text = (gzip.decompress(blob) if compressed else blob).decode("utf-8")
                yield dense, meta, text
                dense += 1

    def fetch_filter_columns(self) -> list[tuple[str, str, str]]:
        """(case_id, court, decision_date) rows for the device-column export.

        Ordered by insertion (sqlite rowid) so dense row ids are **stable
        under append** — incremental index updates extend the row space
        without renumbering existing postings."""
        with self._lock:
            return self._conn.execute(
                "SELECT case_id, COALESCE(court, ''), COALESCE(decision_date, '') "
                "FROM case_metadata ORDER BY rowid"
            ).fetchall()

    # -- maintenance --------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            self._conn.commit()

    def get_stats(self) -> StorageStats:
        """Counts + size on disk (ref: storage.rs:295-314)."""
        with self._lock:
            meta_count = self._conn.execute(
                "SELECT COUNT(*) FROM case_metadata"
            ).fetchone()[0]
            text_count = self._conn.execute(
                "SELECT COUNT(*) FROM case_text"
            ).fetchone()[0]
        size = 0
        if self._db_path != ":memory:":
            p = Path(self._db_path)
            for f in (p, Path(str(p) + "-wal"), Path(str(p) + "-shm")):
                if f.exists():
                    size += f.stat().st_size
        return StorageStats(
            total_cases=meta_count,
            total_metadata_entries=meta_count,
            total_text_entries=text_count,
            db_size_bytes=size,
            compression_enabled=self.config.enable_compression,
        )

    def health_check(self) -> None:
        """Write-read-delete probe (ref: storage.rs:317-350)."""
        probe_key = f"__health_probe_{uuid.uuid4()}"
        with self._lock:
            try:
                self._conn.execute(
                    "INSERT INTO case_text (case_id, compressed, text) VALUES (?, 0, ?)",
                    (probe_key, b"probe"),
                )
                row = self._conn.execute(
                    "SELECT text FROM case_text WHERE case_id = ?", (probe_key,)
                ).fetchone()
                self._conn.execute(
                    "DELETE FROM case_text WHERE case_id = ?", (probe_key,)
                )
                self._conn.commit()
            except sqlite3.Error as e:
                raise DatabaseError(f"health probe failed: {e}") from e
        if row is None or bytes(row[0]) != b"probe":
            raise StorageCorruption(
                location="health_probe", details="read-back mismatch"
            )

    def create_backup(self) -> Optional[Path]:
        """A timestamped copy of the database in ``backup.backup_dir``
        (sqlite's online backup, consistent under WAL), keeping the newest
        ``backup.max_backups``; None when backups are off or the store is
        in memory."""
        if not self.config.backup.enabled or self._db_path == ":memory:":
            return None
        backup_dir = Path(self.config.backup.backup_dir)
        backup_dir.mkdir(parents=True, exist_ok=True)
        dest = backup_dir / f"legal_search_{time.strftime('%Y%m%d_%H%M%S')}.db"
        with self._lock:
            target = sqlite3.connect(dest)
            try:
                self._conn.backup(target)
            finally:
                target.close()
        backups = sorted(backup_dir.glob("legal_search_*.db"))
        for old in backups[: max(0, len(backups) - self.config.backup.max_backups)]:
            old.unlink(missing_ok=True)
        return dest

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def __enter__(self) -> "StorageManager":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
