"""Tracing and profiling utilities.

The port of the JAX package's `core/profiling.py`, on `torch.profiler`:

- `trace(log_dir)` records CPU and, where a card is visible, CUDA activity
  for a scope and writes one Chrome-trace file
  (``<host>_<pid>.<stamp>.pt.trace.json``) into `log_dir`, which Perfetto
  (ui.perfetto.dev) and TensorBoard's profiler plugin open;
- `annotate(name)` is a named span in that timeline
  (`torch.profiler.record_function`);
- `timed(fn, ...)`: the median wall-clock seconds of calls fenced by
  `torch.cuda.synchronize` on a card (PyTorch returns before the device
  finishes, so an unfenced host clock measures the enqueue).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, Tuple

import torch

from spotify_recommender_tpu_torch.core.logging import get_logger

log = get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the scope's CPU and CUDA activity into a trace file under
    `log_dir` (created if absent); yields the profiler, whose
    `key_averages()` sum the recorded ops and kernels."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _sync()
    log.info("trace written to %s", log_dir)


def annotate(name: str):
    """Named span that shows up in the profiler's timeline."""
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs
          ) -> Tuple[float, Any]:
    """(median seconds per call, last output), each call fenced by a
    device synchronization where CUDA is in use."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args, **kwargs)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out
