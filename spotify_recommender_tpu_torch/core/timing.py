"""Timing of work on a device, shared by `chip_smoke.py` and the experiment
paths (`spotify_recommender_tpu_torch/experiments/`)."""

from __future__ import annotations

import statistics
import time
from typing import Callable, Union

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
