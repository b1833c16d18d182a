"""The traced window: torch.profiler over a steady stretch of the same
closed loop, reduced to what the per-layer metrics and the result's
`breakdown` read.

- `busy_s`: the union of the device's operations (kernels, copies, sets)
  inside the window; `window_s` the window's length, both on the
  profiler's clock.
- `kernel_seconds`: device seconds per operation name inside the window.
- `idle_gaps`: each stretch with no device operation, named by what the
  main thread was doing at its start: the benchmark's own span
  (`bench.batch`, or outside a batch) and the innermost host op under
  it.

A profiler session on a card can lose the first kernels it sees, so the
session opens with small synchronized kernels for 0.1 s before the window,
and CUPTI is kept between sessions (TEARDOWN_CUPTI=0).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Callable, Dict, List, Tuple

import torch

WINDOW_SPAN = "bench.window"
BATCH_SPAN = "bench.batch"
WARMUP_S = 0.1


@dataclasses.dataclass
class Trace:
    batches: int
    window_s: float
    busy_s: float
    kernel_seconds: Dict[str, float]
    idle_gaps: Dict[str, float]


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without `void ` and its parameter list (a copy's
    name, whose parenthesis follows a space, is kept whole)."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for j in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[j], 0)
            if depth == 0:
                if j > 0 and name[j - 1] != " ":
                    name = name[:j]
                break
    return name[:limit]


def _warm_up(device: torch.device) -> None:
    x = torch.zeros(1, device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        x.add_(1)
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event: times in microseconds on the profiler's clock;
    `device` for an operation on the card (not a span projected there)."""

    name: str
    start: float
    end: float
    device: bool
    thread: int


def events_of(prof) -> List[Event]:
    """A finished session's events, read from kineto's raw records (a
    hundred times faster than `prof.events()` on a dense trace)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == cuda
        if dev and e.is_user_annotation():
            continue
        start = e.start_ns() * 1e-3
        out.append(Event(e.name(), start, start + e.duration_ns() * 1e-3,
                         dev, e.start_thread_id()))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _host_at(points: List[float], host) -> List[str]:
    """For each point (ascending), what the main thread was doing: its
    benchmark span, the op called under it and the innermost op open at
    the point, from a sweep over properly nested host events."""
    names = []
    stack: List[tuple] = []
    j = 0
    for t in points:
        while j < len(host) and host[j][0] <= t:
            s, e, name = host[j]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        path = [n for _, _, n in stack if n != WINDOW_SPAN]
        spans = [n for n in path if n.startswith("bench.")]
        ops = [n for n in path if not n.startswith("bench.")]
        parts = [spans[-1] if spans else "outside a batch"]
        parts += ops[:1] + ops[-1:] if len(ops) > 1 else ops
        if not ops:
            parts.append("(python between ops)")
        names.append(" > ".join(parts))
    return names


def reduce(events: List[Event], batches: int) -> Trace:
    """A finished session's events as a `Trace` of its `bench.window`."""
    window = next(e for e in events if e.name == WINDOW_SPAN and not e.device)
    w0, w1 = window.start, window.end
    dev: List[Tuple[float, float]] = []
    per_name: Dict[str, float] = collections.defaultdict(float)
    host = []
    for e in events:
        if e.device:
            s, t = max(e.start, w0), min(e.end, w1)
            if t > s:
                dev.append((s, t))
                per_name[short_name(e.name)] += (t - s) * 1e-6
        elif e.thread == window.thread and e.end > w0 and e.start < w1:
            host.append((e.start, e.end, e.name))
    host.sort(key=lambda h: (h[0], -h[1]))
    busy = _union(dev)
    gaps = []
    prev = w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    idle: Dict[str, float] = collections.defaultdict(float)
    for (s, t), name in zip(gaps, _host_at([g[0] for g in gaps], host)):
        idle[name] += (t - s) * 1e-6
    return Trace(
        batches=batches,
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(t - s for s, t in busy) * 1e-6,
        kernel_seconds=dict(per_name),
        idle_gaps=dict(idle),
    )


def traced_window(loop: Callable[[], int], device: torch.device) -> Trace:
    """Run `loop` (which returns its batch count) inside a profiler
    session, within the `bench.window` span, and reduce the session."""
    from torch.profiler import ProfilerActivity, profile, record_function

    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if device.type == "cuda":
            _warm_up(device)
        with record_function(WINDOW_SPAN):
            batches = loop()
    return reduce(events_of(prof), batches)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The n largest entries of a name -> seconds map, as [name, s]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
