"""Cosine-similarity scoring: the plain torch oracle.

Re-states the reference's similarity math (identical on its GPU and CPU
paths):

- dot products as one fp32 matrix product (the reference's cuBLAS SGEMV,
  Recommender.cu:217-223).  fp32 means no TF32: the retriever turns TF32
  off (see `disable_tf32`), the torch form of the JAX package's
  `Precision.HIGHEST`;
- cosine normalization with the 1e-8 zero-denominator guard and [-1, 1]
  clamp (reference Recommender.cu:62-77 GPU, :256-273 CPU);
- top-k with the lowest index first on ties (reference heap,
  Recommender.cu:300-305);
- self-exclusion by masking the query row to -inf before top-k
  (reference skips the query index during heap fill, Recommender.cu:296).

This module is the *oracle* the certified tier is held against, and the
fallback that serves the queries whose certificate fails.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spotify_recommender_tpu_torch.core.config import COSINE_EPS
from spotify_recommender_tpu_torch.ops.topk import merge_topk, topk_stable

NEG_INF = float("-inf")


def disable_tf32() -> None:
    """Make fp32 matrix products and convolutions true fp32 on CUDA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """fp32 L2 norm of each row.  The certified rerank and the oracle both
    take query norms from here, so a certified answer's scores are the
    oracle's scores."""
    return torch.linalg.vector_norm(x.to(torch.float32), dim=1)


def cosine_scores_batched(
    queries: torch.Tensor,
    features: torch.Tensor,
    norms: Optional[torch.Tensor] = None,
    eps: float = COSINE_EPS,
) -> torch.Tensor:
    """Cosine similarity of a query batch (B, F) against the catalog (N, F):
    clamp(dot / (|q| |x|), -1, 1) where the denominator > eps, else 0."""
    queries = queries.to(torch.float32)
    features = features.to(torch.float32)
    if norms is None:
        norms = row_norms(features)
    q_norms = row_norms(queries)
    dots = queries @ features.T
    denom = q_norms[:, None] * norms[None, :]
    guard = denom > eps
    return torch.where(
        guard,
        torch.clamp(dots / torch.where(guard, denom, 1.0), -1.0, 1.0),
        0.0,
    )


def _mask_self(scores: torch.Tensor, exclude_rows: torch.Tensor) -> torch.Tensor:
    """Mask scores[b, exclude_rows[b]] to -inf; -1 disables exclusion."""
    cols = torch.arange(scores.shape[1], device=scores.device)[None, :]
    return scores.masked_fill(cols == exclude_rows.long()[:, None], NEG_INF)


def topk_scores(
    scores: torch.Tensor,
    k: int,
    exclude_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a (B, N) score matrix with optional per-row
    self-exclusion; ties break toward the lower catalog index."""
    if exclude_rows is not None:
        scores = _mask_self(scores, exclude_rows)
    return topk_stable(scores, k)


def exact_topk(
    queries: torch.Tensor,
    features: torch.Tensor,
    norms: Optional[torch.Tensor] = None,
    exclude_rows: Optional[torch.Tensor] = None,
    k: int = 10,
    eps: float = COSINE_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact retrieval over the full (B, N) score matrix.

    Returns (top_scores (B, k), top_indices (B, k))."""
    scores = cosine_scores_batched(queries, features, norms, eps)
    return topk_scores(scores, k, exclude_rows)


def exact_topk_iterative(
    queries: torch.Tensor,
    features: torch.Tensor,
    norms: Optional[torch.Tensor] = None,
    exclude_rows: Optional[torch.Tensor] = None,
    k: int = 10,
    eps: float = COSINE_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle-exact top-k via k rounds of max + first-occurrence argmax
    (`torch.argmax` documents that it returns the first maximal index), with
    each winner masked before the next round."""
    scores = cosine_scores_batched(queries, features, norms, eps)
    if exclude_rows is not None:
        scores = _mask_self(scores, exclude_rows)
    rows = torch.arange(scores.shape[0], device=scores.device)
    out_s, out_i = [], []
    for _ in range(k):
        am = torch.argmax(scores, dim=1)
        out_s.append(scores[rows, am])
        out_i.append(am)
        scores[rows, am] = NEG_INF
    return torch.stack(out_s, dim=1), torch.stack(out_i, dim=1)


def exact_topk_chunked(
    queries: torch.Tensor,
    features: torch.Tensor,
    norms: Optional[torch.Tensor] = None,
    exclude_rows: Optional[torch.Tensor] = None,
    k: int = 10,
    eps: float = COSINE_EPS,
    chunk: int = 131072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact retrieval over catalog chunks in ascending index order.

    Peak memory is O(B x chunk) instead of O(B x N).  Per-chunk top-k +
    merge keeps the lowest-index tie rule, because chunks ascend and
    `merge_topk` favors the earlier list, so results equal `exact_topk`.
    """
    queries = queries.to(torch.float32)
    features = features.to(torch.float32)
    if norms is None:
        norms = row_norms(features)
    n, b = features.shape[0], queries.shape[0]
    dev = queries.device
    best_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for off in range(0, n, chunk):
        scores = cosine_scores_batched(
            queries, features[off:off + chunk], norms[off:off + chunk], eps
        )
        if exclude_rows is not None:
            scores = _mask_self(scores, exclude_rows.long() - off)
        ch_s, ch_pos = topk_stable(scores, k)
        if ch_s.shape[1] < k:       # a last chunk narrower than k
            pad = k - ch_s.shape[1]
            ch_s = torch.nn.functional.pad(ch_s, (0, pad), value=NEG_INF)
            ch_pos = torch.nn.functional.pad(ch_pos, (0, pad), value=-1 - off)
        best_s, best_i = merge_topk(best_s, best_i, ch_s, ch_pos + off, k)
    return best_s, best_i
