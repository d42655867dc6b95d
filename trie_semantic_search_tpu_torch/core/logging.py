"""Logging setup (port of ``trie_semantic_search_tpu/core/logging.py``):
plain or JSON records (timestamp, level, target, thread id, message) at the
level of the ``logging`` config section, to stderr or a file."""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Optional

from .config import LoggingConfig

_LEVELS = {
    "trace": logging.DEBUG,  # Python has no TRACE
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class JsonFormatter(logging.Formatter):
    """One JSON object per record: timestamp, level, target, threadId and
    ``fields.message`` (plus ``fields.exception`` with a traceback)."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "threadId": threading.get_ident(),
            "fields": {"message": record.getMessage()},
        }
        if record.exc_info:
            payload["fields"]["exception"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def init_logging(config: Optional[LoggingConfig] = None) -> None:
    """Point the root logger at one handler configured by ``config``."""
    config = config or LoggingConfig()
    level = _LEVELS.get(config.level.lower(), logging.INFO)
    handler: logging.Handler
    if config.file_path:
        handler = logging.FileHandler(config.file_path)
    else:
        handler = logging.StreamHandler(sys.stderr)
    if config.json_format:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)-5s %(name)s: %(message)s",
                datefmt="%Y-%m-%dT%H:%M:%S",
            )
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"tss_torch.{name}")
