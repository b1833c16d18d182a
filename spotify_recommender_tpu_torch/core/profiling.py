"""Tracing and profiling utilities.

The port of the JAX package's `core/profiling.py`, on `torch.profiler`:

- `trace(log_dir)` records CPU and, where a card is visible, CUDA activity
  for a scope and writes one Chrome-trace file
  (``<host>_<pid>.<stamp>.pt.trace.json``) into `log_dir`, which Perfetto
  (ui.perfetto.dev) and TensorBoard's profiler plugin open.  On a card,
  a session after the process's first one loses the first kernels it
  sees (measured with torch 2.11 on an H100, `tools/trace_bisect.py`: a
  certified batch traced 150 s after an earlier session lost its first 11
  of 153 kernels, kernels 2 and 1 among them, however long the session
  waited first; in a process that had run for minutes a session of 20
  kernels lost them all; a warm-up of small kernels, each synchronized,
  for 50 ms before the batch lost none of it).  So `trace` opens its
  session with a warm-up step of such kernels (`WARMUP_S`), whose events
  the schedule discards, and records the scope in the step after it; and
  it keeps CUPTI initialized between the process's sessions
  (``TEARDOWN_CUPTI=0``, as torch.profiler itself sets under CUDA
  graphs): in `chip_smoke.py`'s long process the warm-up alone still let
  a 20-kernel session lose all of its kernels, the two together none.  A
  trace that requested CUDA activity and recorded no device event logs an
  error;
- `annotate(name)` is a named span in that timeline
  (`torch.profiler.record_function`), opened by `core/timing.Spans` for
  its phases while a session collects (`collecting`);
- `timed(fn, ...)`: the median wall-clock seconds of calls fenced by
  `torch.cuda.synchronize` on a card (PyTorch returns before the device
  finishes, so an unfenced host clock measures the enqueue).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, Tuple

import torch

from spotify_recommender_tpu_torch.core.logging import get_logger

log = get_logger(__name__)

# seconds of small synchronized kernels in the warm-up step of a trace
WARMUP_S = 0.1


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the scope's CPU and CUDA activity into a trace file under
    `log_dir` (created if absent); yields the profiler, whose
    `key_averages()` sum the recorded ops and kernels."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        schedule,
        tensorboard_trace_handler,
    )

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        # read by kineto when a session ends: keep CUPTI for the next one
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
    with profile(activities=activities,
                 schedule=(schedule(wait=0, warmup=1, active=1, repeat=1)
                           if cuda else None),
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        if cuda:
            _warm_up()
            prof.step()          # the warm-up's events are discarded
        yield prof
        _sync()
    if cuda and torch.cuda.is_initialized():
        check_device_events(prof, log_dir)
    log.info("trace written to %s", log_dir)


def device_events(prof: torch.profiler.profile) -> int:
    """Device (CUDA) activity a finished profiler session recorded:
    kernels, copies and sets; not the spans (the schedule's step, an
    `annotate`) that the trace projects onto the device's timeline."""
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               for e in prof.events())


def check_device_events(prof: torch.profiler.profile, where: str) -> int:
    """`device_events` of a session that requested CUDA activity; logs an
    error where there are none (CUPTI missed the scope's kernels)."""
    n = device_events(prof)
    if not n:
        log.error("trace in %s requested CUDA activity and recorded no "
                  "device event: CUPTI missed the scope's kernels", where)
    return n


def annotate(name: str):
    """Named span that shows up in the profiler's timeline."""
    return torch.profiler.record_function(name)


def collecting() -> bool:
    """Whether a profiler session is recording in this process: a range of
    `annotate` costs ~10 us a call even with none open, so the span
    recorder (`core/timing.Spans`) opens one only while this holds."""
    return torch.autograd.profiler._is_profiler_enabled


def _warm_up() -> None:
    """Small kernels on the current device, each synchronized, for
    WARMUP_S seconds."""
    x = torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        x.add_(1)
        torch.cuda.synchronize()


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
