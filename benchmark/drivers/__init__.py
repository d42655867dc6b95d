"""Generic traffic drivers; a traffic file names one under ``driver``.

A driver module has ``queries_needed(traffic, seconds, trace)``,
``warm(session)``, ``measure(session, seconds, trace)`` and
``close(session)``. ``measure`` returns the window's observations: the
answers by query index, ``attempted``, ``failed``, ``window_s``,
``answered``, and what its metrics read."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")
