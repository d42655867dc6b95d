"""Ingestion cache manager (port of ``trie_semantic_search_tpu/ingest/
cache.py``):

* the per-source last-update **watermark** (where an incremental ingest
  resumes), kept in ``watermarks.json`` under ``disk_cache_path``
* the **processed-case cache** keyed by content hash: a bounded LRU in
  memory with a TTL (the port's :class:`~..search.cache._LruTtl`, which
  takes a lock, so pipeline workers share it) and JSON files under
  ``disk_cache_path/processed``
* stats, clear, flush and a health probe.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from ..core.config import CacheConfig
from ..search.cache import _LruTtl
from ..utils import TextUtils

_log = logging.getLogger("tss_torch.ingest.cache")


@dataclass
class IngestCacheStats:
    memory_entries: int = 0
    disk_entries: int = 0
    hits: int = 0
    misses: int = 0
    watermarks: int = 0


def content_key(metadata_name: str, text: str) -> str:
    """Stable content-hash cache key."""
    return TextUtils.text_hash(metadata_name + "\x00" + text)


class CacheManager:
    def __init__(self, config: Optional[CacheConfig] = None):
        self.config = config or CacheConfig()
        ttl = self.config.ttl_hours * 3600 if self.config.ttl_hours else None
        self._mem: _LruTtl[dict] = _LruTtl(max_size=self.config.max_memory_entries, ttl_seconds=ttl)
        self._watermarks: dict[str, _dt.datetime] = {}
        self._disk: Optional[Path] = (
            Path(self.config.disk_cache_path) if self.config.disk_cache_path else None
        )
        if self._disk:
            (self._disk / "processed").mkdir(parents=True, exist_ok=True)
            self._load_watermarks()

    # -- watermarks ---------------------------------------------------------

    def get_last_update(self, source: str) -> Optional[_dt.datetime]:
        return self._watermarks.get(source)

    def set_last_update(self, source: str, when: _dt.datetime) -> None:
        self._watermarks[source] = when
        self._save_watermarks()

    def _watermark_file(self) -> Optional[Path]:
        return self._disk / "watermarks.json" if self._disk else None

    def _load_watermarks(self) -> None:
        f = self._watermark_file()
        if f and f.exists():
            try:
                raw = json.loads(f.read_text())
                self._watermarks = {k: _dt.datetime.fromisoformat(v) for k, v in raw.items()}
            except (ValueError, OSError) as e:
                _log.warning("failed to load watermarks: %s", e)

    def _save_watermarks(self) -> None:
        f = self._watermark_file()
        if f:
            f.write_text(json.dumps({k: v.isoformat() for k, v in self._watermarks.items()}))

    # -- processed-case cache -----------------------------------------------

    def get_processed_case(self, key: str) -> Optional[dict[str, Any]]:
        if not self.config.enabled:
            return None
        hit = self._mem.get(key)
        if hit is not None:
            return hit
        if self._disk:
            f = self._disk / "processed" / f"{key}.json"
            if f.exists():
                try:
                    data = json.loads(f.read_text())
                    self._mem.put(key, data)
                    return data
                except (ValueError, OSError):
                    f.unlink(missing_ok=True)
        return None

    def store_processed_case(self, key: str, data: dict[str, Any]) -> None:
        if not self.config.enabled:
            return
        self._mem.put(key, data)
        if self._disk:
            try:
                (self._disk / "processed" / f"{key}.json").write_text(json.dumps(data))
            except OSError as e:
                _log.warning("disk cache write failed: %s", e)

    # -- maintenance --------------------------------------------------------

    def clear_memory_cache(self) -> None:
        self._mem.clear()

    def clear_source_cache(self, source: str) -> None:
        self._watermarks.pop(source, None)
        self._save_watermarks()

    def flush(self) -> None:
        self._save_watermarks()

    def health_check(self) -> None:
        probe_key = "__cache_probe__"
        self._mem.put(probe_key, {"ok": True})
        if self._mem.get(probe_key) != {"ok": True}:
            raise RuntimeError("the processed-case cache lost its probe entry")

    def get_stats(self) -> IngestCacheStats:
        mem = self._mem.get_stats()
        disk_entries = 0
        if self._disk:
            disk_entries = sum(1 for _ in (self._disk / "processed").glob("*.json"))
        return IngestCacheStats(
            memory_entries=mem.size,
            disk_entries=disk_entries,
            hits=mem.hits,
            misses=mem.misses,
            watermarks=len(self._watermarks),
        )
