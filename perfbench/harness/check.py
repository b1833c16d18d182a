"""How `correct` is decided: the answers the timed path gave, for a sample of
its batches drawn from the seed, against the plain float64 reference
(reference/cosine_topk.py), which works every answer out again from the
benchmark's own inputs.

Three numbers, each held to the cell's limit (limits/<cell>.json):

- `bad_rows`: answer slots that cannot be right whatever the scores: a row
  outside the catalog, the query's excluded row, a row twice in one
  answer, a score that is not finite, or a batch answered in another shape
  (all its slots).  Limit 0.
- `rank_gap`: the widest gap, over every query and rank r, by which the
  served row's reference score lies below the reference's r-th best.  A
  wrong row, a missed row or a wrong order shows here; two rows whose
  scores tie within float32 rounding may trade places by ~1e-7.
- `score_gap`: the widest gap between a served score and the reference's
  score of the served row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import cosine_topk


@dataclasses.dataclass
class Answer:
    """One batch of the window: its queries, exclusions and what the
    program answered."""

    queries: np.ndarray     # (B, F) float32
    exclude: np.ndarray     # (B,) int64
    scores: np.ndarray      # as served
    rows: np.ndarray        # as served


def _bad_slots(rows: np.ndarray, scores: np.ndarray, excl: np.ndarray,
               n: int) -> np.ndarray:
    """(B, k) True where a slot cannot be right."""
    bad = (rows < 0) | (rows >= n) | (rows == excl[:, None])
    bad |= ~np.isfinite(scores)
    order = np.argsort(rows, axis=1, kind="stable")
    srt = np.take_along_axis(rows, order, axis=1)
    dup_sorted = np.zeros_like(bad)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = np.zeros_like(bad)
    np.put_along_axis(dup, order, dup_sorted, axis=1)   # every repeat after
    return bad | dup                                     # the first


def compare(catalog: torch.Tensor, answers: List[Answer], k: int
            ) -> Dict[str, float]:
    """The three numbers over `answers`, with `answers_compared`."""
    n = catalog.shape[0]
    bad = 0
    rank_gap = 0.0
    score_gap = 0.0
    compared = 0
    for a in answers:
        b = a.queries.shape[0]
        rows = np.asarray(a.rows)
        scores = np.asarray(a.scores)
        if rows.shape != (b, k) or scores.shape != (b, k):
            bad += b * k
            continue
        rows = rows.astype(np.int64)
        scores = scores.astype(np.float64)
        slot_bad = _bad_slots(rows, scores, a.exclude, n)
        bad += int(slot_bad.sum())
        q = torch.from_numpy(np.ascontiguousarray(a.queries))
        excl = torch.from_numpy(a.exclude.astype(np.int64))
        ref_s, _ = cosine_topk.reference_topk(catalog, q, excl, k)
        served = cosine_topk.reference_scores(
            catalog, q, torch.from_numpy(np.clip(rows, 0, n - 1)))
        ok = torch.from_numpy(~slot_bad).to(served.device)
        gap = (ref_s - served).masked_fill(~ok, 0.0)
        diff = (torch.from_numpy(scores).to(served.device) - served).abs()
        rank_gap = max(rank_gap, float(gap.max()))
        score_gap = max(score_gap, float(diff.masked_fill(~ok, 0.0).max()))
        compared += b
    return {"bad_rows": float(bad), "rank_gap": rank_gap,
            "score_gap": score_gap, "answers_compared": float(compared)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit, and something compared."""
    return (numbers.get("answers_compared", 0.0) > 0
            and all(numbers[name] <= limit for name, limit in limits.items()))
