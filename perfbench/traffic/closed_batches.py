"""The generator of closed-loop batch traffic from one client: a pool of
distinct batches of catalog rows drawn uniformly from the seed, each
excluding itself where the mix says so, answered in turn, each batch
started once the previous one answered.

A mix (traffic/<mix>.json) that names this generator gives: `batch`, `k`,
`exclude_self`, `pool_batches` (distinct batches made in set-up),
`warm_batches` (of them answered in set-up), `check_batches` (answers
kept for the check) and `trace_seconds` (the traced stretch).  Another
kind of traffic is another generator, named by a mix's `generator` key,
with the same two functions."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from perfbench.harness.window import Recorder, Window


def make_pool(features: torch.Tensor, traffic: dict, gen: torch.Generator):
    """The mix's distinct batches: (queries (B, F) float32, exclusions
    (B,) int64, -1 for none) on the host."""
    b, p = traffic["batch"], traffic["pool_batches"]
    rows = torch.randint(0, features.shape[0], (p, b), generator=gen,
                         device=features.device)
    queries = features[rows.reshape(-1)].reshape(p, b, -1).cpu().numpy()
    rows = rows.cpu().numpy()
    none = np.full(b, -1, np.int64)
    return [(np.ascontiguousarray(queries[j]),
             rows[j].copy() if traffic["exclude_self"] else none)
            for j in range(p)]


def run_window(call: Callable, pool, traffic: dict, seconds: float,
               keep: int, seed: int) -> Window:
    """Batches of the pool in turn, back to back, until `seconds` have
    passed; `keep` answers kept, drawn from the seed."""
    rec = Recorder(keep, seed)
    deadline = rec.start + seconds
    i = 0
    while rec.end < deadline:
        rec.batch(call, *pool[i % len(pool)])
        i += 1
    return rec.window()
