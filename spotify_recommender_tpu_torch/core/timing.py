"""Timing of work on a device, shared by `chip_smoke.py`, the trainers
(`models/`) and the experiment paths
(`spotify_recommender_tpu_torch/experiments/`), and the span recorder of
the trainers, the retrieval path and the service (`Spans`)."""

from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import threading
import time
from typing import (Callable, Deque, Dict, List, NamedTuple, Optional,
                    Union)

import torch

from spotify_recommender_tpu_torch.core import profiling


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


class SpanRecord(NamedTuple):
    """One closed span, on the host clock (`time.perf_counter_ns`)."""

    name: str
    parent: Optional[str]    # the enclosing span on its thread; None: a root
    batch: int               # the root span's sequence number
    start_ns: int
    end_ns: int


class Spans:
    """Named spans, timed on the host clock and kept two ways: a bounded
    ring of recent records (`records`: name, parent, batch, start, end) and
    totals per name as each span closes (`totals`: count, seconds, and self
    seconds, the duration less that of its children).

    A span opened while another is open on the same thread is its child
    and shares its batch: the root's sequence number (`new_batch`), unless
    the root was given one.  A span opened with `phase=True`, one with no
    child spans, is also a `profiling.annotate` range while a profiler
    session collects, so that it sits on the profiler's clock beside the
    kernels.  `record` adds a span timed elsewhere, one that starts on one
    thread and ends on another.

    Built with a device, as the trainers build it (`models/mf.train_als(
    stats=...)` records its halves and the Cholesky factor + solve inside
    them, `models/two_tower.train(stats=...)` its steps), it also keeps
    each span's milliseconds for `read`: CUDA events on a card (read, with
    one synchronize, by `read`), the host clock on the CPU.  Without one
    (`Retriever.record_spans`, the service's `record_spans=True`) it keeps
    only the records and totals."""

    RING = 4096      # records kept: a few hundred batches' worth

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._keep_marks = device is not None
        self._marks: list = []
        self._ring: Deque[tuple] = collections.deque(maxlen=self.RING)
        self._totals: Dict[str, List[int]] = {}   # name: [count, ns, self ns]
        self._lock = threading.Lock()
        self._local = threading.local()
        self._batches = itertools.count()

    def __call__(self, name: str, phase: bool = False,
                 batch: Optional[int] = None) -> "_Span":
        """A span of the `with` block; a root takes `batch` if given."""
        return _Span(self, name, phase, batch)

    def new_batch(self) -> int:
        """The next batch id, for a root, or a `record`, that joins it."""
        return next(self._batches)

    def record(self, name: str, start_ns: int, end_ns: int,
               parent: Optional[str] = None,
               batch: Optional[int] = None) -> None:
        """A span timed elsewhere (`time.perf_counter_ns`), with no child;
        a new batch unless `batch` is given."""
        if batch is None:
            batch = self.new_batch()
        self._close(name, parent, batch, start_ns, end_ns, 0)

    def records(self) -> List[SpanRecord]:
        """The most recent closed spans, oldest first."""
        with self._lock:
            return [SpanRecord(*r) for r in self._ring]

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "s", "self_s"}} over every span closed so far."""
        with self._lock:
            return {n: {"count": c, "s": ns * 1e-9, "self_s": own * 1e-9}
                    for n, (c, ns, own) in self._totals.items()}

    def read(self) -> Dict[str, float]:
        """Milliseconds per name of a trainer's spans since the last
        `read`."""
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, start, end in self._marks:
            ms = start.elapsed_time(end) if self.cuda else (end - start) * 1e-6
            out[name] = out.get(name, 0.0) + ms
        self._marks = []
        return out

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _close(self, name: str, parent: Optional[str], batch: int,
               start_ns: int, end_ns: int, child_ns: int) -> None:
        ns = end_ns - start_ns
        with self._lock:
            self._ring.append((name, parent, batch, start_ns, end_ns))
            t = self._totals.get(name)
            if t is None:
                t = self._totals[name] = [0, 0, 0]
            t[0] += 1
            t[1] += ns
            t[2] += ns - child_ns


class _Span:
    """One open span of a `Spans` (a context manager)."""

    __slots__ = ("spans", "name", "phase", "batch", "parent", "start",
                 "child_ns", "range", "events")

    def __init__(self, spans: Spans, name: str, phase: bool,
                 batch: Optional[int]) -> None:
        self.spans, self.name, self.phase, self.batch = (spans, name, phase,
                                                         batch)

    def __enter__(self) -> "_Span":
        sp = self.spans
        stack = sp._stack()
        if stack:
            self.parent = stack[-1].name
            self.batch = stack[-1].batch
        else:
            self.parent = None
            if self.batch is None:
                self.batch = sp.new_batch()
        stack.append(self)
        self.child_ns = 0
        self.range = None
        self.start = time.perf_counter_ns()
        if self.phase and profiling.collecting():
            self.range = profiling.annotate(self.name)
            self.range.__enter__()
        if sp.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        sp = self.spans
        if sp.cuda:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        stack = sp._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += end - self.start
        sp._close(self.name, self.parent, self.batch, self.start, end,
                  self.child_ns)
        if sp._keep_marks:
            sp._marks.append((self.name, *self.events) if sp.cuda
                             else (self.name, self.start, end))


def span(spans: Optional[Spans], name: str, phase: bool = False,
         batch: Optional[int] = None):
    """`spans(name, phase, batch)`, or a context that does nothing where
    `spans` is None: recording off costs this one check."""
    return _OFF if spans is None else spans(name, phase, batch)


_OFF = contextlib.nullcontext()
