"""Periodic maintenance of ``serve`` (port of ``trie_semantic_search_tpu/
core/maintenance.py``): timed store backups with retention and a memory
watchdog that clears the caches, each a daemon thread."""

from __future__ import annotations

import gc
import logging
import threading
from typing import Callable, Optional

from ..utils import SystemUtils

_log = logging.getLogger("tss_torch.maintenance")


class PeriodicTask:
    """Daemon thread running ``fn`` every ``interval_seconds``.

    ``run_at_start=True`` fires once at start: without it a long-interval
    task (daily backups) on a server restarted more often than that would
    never run. A failing ``fn`` is logged and counted in ``errors``."""

    def __init__(
        self,
        name: str,
        interval_seconds: float,
        fn: Callable[[], None],
        run_at_start: bool = False,
    ):
        self.name = name
        self.interval = interval_seconds
        self.fn = fn
        self.run_at_start = run_at_start
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.runs = 0
        self.errors = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()  # restartable after stop()
        self._thread = threading.Thread(
            target=self._loop, name=f"maintenance-{self.name}", daemon=True
        )
        self._thread.start()

    def _tick(self) -> None:
        try:
            self.fn()
            self.runs += 1
        except Exception as e:
            self.errors += 1
            _log.warning("%s maintenance failed: %s", self.name, e)

    def _loop(self) -> None:
        if self.run_at_start:
            self._tick()
        while not self._stop.wait(self.interval):
            self._tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def make_backup_task(storage, backup_config) -> Optional[PeriodicTask]:
    """sqlite online backups every ``interval_hours`` (and at start), with
    the store's retention; None when backups are off."""
    if not backup_config.enabled:
        return None

    def run() -> None:
        dest = storage.create_backup()
        if dest is not None:
            _log.info("backup written: %s", dest)

    return PeriodicTask("backup", backup_config.interval_hours * 3600, run, run_at_start=True)


def _total_memory() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def make_gc_task(gc_config, caches: Optional[list] = None) -> Optional[PeriodicTask]:
    """Memory watchdog: each tick, when the resident set exceeds
    ``memory_threshold_percent`` of the host's memory, clear ``caches`` and
    collect garbage; None when off."""
    if not gc_config.enabled:
        return None
    caches = caches or []

    def run() -> None:
        rss = SystemUtils.memory_usage()
        total = _total_memory()
        if rss is None or total is None:
            return
        pct = 100.0 * rss / total
        if pct >= gc_config.memory_threshold_percent:
            _log.warning(
                "RSS %s is %.0f%% of system memory (threshold %d%%); "
                "collecting garbage and clearing caches",
                SystemUtils.format_bytes(rss), pct, gc_config.memory_threshold_percent,
            )
            for cache in caches:
                cache.clear()
            gc.collect()

    return PeriodicTask("gc", gc_config.interval_seconds, run)
