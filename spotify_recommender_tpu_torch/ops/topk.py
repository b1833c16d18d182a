"""Top-k selection and merge primitives with a fixed tie order.

The reference selects top-N with a host min-heap that keeps the lowest
index on ties (reference Recommender.cu:293-315).  `torch.topk` documents
no tie order, so every selection here is a *stable* descending sort: equal
scores keep their input order, and inputs ordered by ascending index give
the lowest index first — `lax.top_k`'s rule in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_stable(
    scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; ties go to the earlier position."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def merge_topk(
    scores_a: torch.Tensor,
    idx_a: torch.Tensor,
    scores_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial top-k lists (B, ka) + (B, kb) → (B, k).

    Ties break toward list order then position; callers pass candidates
    ordered by ascending global index for layout-invariant results.
    """
    scores = torch.cat([scores_a, scores_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    top_scores, pos = topk_stable(scores, k)
    return top_scores, torch.gather(idx, -1, pos)


def merge_topk_deterministic(
    scores: torch.Tensor,
    idx: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over (B, C) candidates with *global-index* tie-breaking:
    sort by (-score, idx) lexicographically, whatever the candidate
    layout."""
    order = torch.argsort(idx, dim=-1, stable=True)
    idx_sorted = torch.gather(idx, -1, order)
    scores_sorted = torch.gather(scores, -1, order)
    top_scores, pos = topk_stable(scores_sorted, k)
    return top_scores, torch.gather(idx_sorted, -1, pos)
