"""Timing of work on a device, shared by `chip_smoke.py`, the trainers
(`models/`) and the experiment paths
(`spotify_recommender_tpu_torch/experiments/`)."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, Optional, Union

import torch


def sync_ms(fn: Callable[[], object], reps: int,
            device: Union[str, torch.device] = "cuda", calls: int = 1) -> float:
    """Median milliseconds per call of `fn` over `reps` timings of `calls`
    calls enqueued back to back, after one warm-up call: CUDA events on a
    card, the host clock on the CPU."""
    on_card = torch.device(device).type == "cuda"
    fn()
    times = []
    for _ in range(reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


class Spans:
    """Milliseconds of named spans of a training loop, summed per name:
    CUDA events on a card (read, with one synchronize, by `read`), the host
    clock on the CPU.  `models/mf.train_als(stats=...)` records its halves
    and the Cholesky factor + solve inside them, `models/two_tower.train(
    stats=...)` its steps."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        self._marks: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._marks.append((name, start, end))

    def read(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, start, end in self._marks:
            ms = start.elapsed_time(end) if self.cuda else (end - start) * 1e3
            out[name] = out.get(name, 0.0) + ms
        self._marks = []
        return out


def span(spans: Optional[Spans], name: str):
    return contextlib.nullcontext() if spans is None else spans(name)
