"""What a traffic generator's window records: each batch timed on the host
from the call to the answer in host arrays, the queries of a batch that
raised counted as failed, and a sample of the answers, drawn from the seed
(a reservoir), kept for the check.  A generator (traffic/<generator>.py)
drives the batches; a `Recorder` times and keeps them."""

from __future__ import annotations

import dataclasses
import random
import sys
import time
import traceback
from typing import Callable, List

from perfbench.harness import check


@dataclasses.dataclass
class Window:
    batches: int
    queries: int
    failed: int
    seconds: float
    times: List[float]
    sample: List[check.Answer]


class Recorder:
    """Times batches and keeps `keep` answers, drawn from `seed`."""

    def __init__(self, keep: int, seed: int) -> None:
        self.keep = keep
        self.rng = random.Random(seed)
        self.times: List[float] = []
        self.sample: List[check.Answer] = []
        self.failed = self.queries = self.batches = 0
        self.start = time.perf_counter()
        self.end = self.start

    def batch(self, call: Callable, q, ex) -> float:
        """One batch through `call`; returns the host clock at its answer."""
        t0 = time.perf_counter()
        try:
            s, r = call(q, ex)
        except Exception:           # counted against `correct`, not hidden
            if not self.failed:
                traceback.print_exc()
            print(f"batch {self.batches} failed", file=sys.stderr)
            self.failed += q.shape[0]
            s = r = None
        self.end = time.perf_counter()
        self.times.append(self.end - t0)
        self.queries += q.shape[0]
        if s is not None:
            i = self.batches
            j = i if i < self.keep else self.rng.randrange(i + 1)
            if j < self.keep:
                a = check.Answer(q, ex, s, r)
                if j < len(self.sample):
                    self.sample[j] = a
                else:
                    self.sample.append(a)
        self.batches += 1
        return self.end

    def window(self) -> Window:
        return Window(self.batches, self.queries, self.failed,
                      self.end - self.start, self.times, self.sample)
