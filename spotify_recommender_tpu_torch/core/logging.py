"""Structured logging.

The reference's observability is bare std::cout/std::cerr lines
(reference DataManager.cpp:144, Recommender.cu:120, main.cpp:134-137).
Here: standard `logging` with a single configurable handler, plus a tiny
phase-timer used by preprocessing.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time
from typing import Dict, Iterator

_ROOT = "spotify_recommender_tpu_torch"
_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def configure(level: int = logging.INFO) -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


class PhaseTimer:
    """Accumulates wall-clock per named phase; used for throughput reporting."""

    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        return ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in self.phases.items())
