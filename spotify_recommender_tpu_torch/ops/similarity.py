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

This module is the *oracle* the certified tier is held against.  The
certified tier's rerank scores with `fixed_order_dots` (the
`fixed_order=True` oracle below), and its fallback, kernel 3 in exact
mode, sums in the same order with the same roundings, so a certified
answer is bitwise what this oracle returns; the "oracle" backend and the
default here keep the matrix product.
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


def fixed_order_dots(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """fp32 dots q . x over the last axis, summed in ascending feature
    order with one rounding per step: `torch.mul`, then `torch.add`, as
    separate ops.  No matmul, bmm or addcmul: their order is the library's,
    and a fused multiply-add rounds once where this rounds twice.  CPU and
    CUDA elementwise fp32 both round to nearest, so the bits are the same
    on both and for any batch shape.  `queries` (..., F) broadcasts against
    `rows` (..., F): (m, 1, F) against gathered (m, C, F) rows, or against
    (1, N, F) for a whole catalog."""
    acc = torch.mul(queries[..., 0], rows[..., 0])
    for j in range(1, queries.shape[-1]):
        acc.add_(torch.mul(queries[..., j], rows[..., j]))
    return acc


def cosine_scores_batched(
    queries: torch.Tensor,
    features: torch.Tensor,
    norms: Optional[torch.Tensor] = None,
    eps: float = COSINE_EPS,
    fixed_order: bool = False,
) -> torch.Tensor:
    """Cosine similarity of a query batch (B, F) against the catalog (N, F):
    clamp(dot / (|q| |x|), -1, 1) where the denominator > eps, else 0.  The
    dots are one fp32 matrix product, or `fixed_order_dots`."""
    queries = queries.to(torch.float32)
    features = features.to(torch.float32)
    if norms is None:
        norms = row_norms(features)
    q_norms = row_norms(queries)
    if fixed_order:
        dots = fixed_order_dots(queries[:, None, :], features[None, :, :])
    else:
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
    fixed_order: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle-exact top-k via k rounds of max + first-occurrence argmax
    (`torch.argmax` documents that it returns the first maximal index), with
    each winner masked before the next round."""
    scores = cosine_scores_batched(queries, features, norms, eps, fixed_order)
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
    fixed_order: bool = False,
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
            queries, features[off:off + chunk], norms[off:off + chunk], eps,
            fixed_order,
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


def mips_topk_chunked(
    queries: torch.Tensor,
    items: torch.Tensor,
    seen_idx: Optional[torch.Tensor] = None,
    seen_mask: Optional[torch.Tensor] = None,
    k: int = 10,
    chunk: int = 131072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact maximum-inner-product top-k over item chunks in ascending
    index order.

    The MF serving primitive (BASELINE config 3): raw fp32 dot scores (no
    cosine epilogue; TF32 must be off, see `disable_tf32`), optional
    per-query *set* exclusion (padded-ragged `seen_idx` (B, S) with
    `seen_mask` (B, S), e.g. each user's training positives), O(B x chunk)
    memory: at B = 4096 and the default chunk one score block is 2 GiB of
    fp32.  Ties break toward the lower item index (`topk_stable` per chunk,
    `merge_topk` favors the earlier list).  As in the JAX function, columns
    past N score -inf and, where fewer than k columns are finite, fill the
    answer with their own indices (>= N) after the excluded ones."""
    queries = queries.to(torch.float32)
    items = items.to(torch.float32)
    n, b = items.shape[0], queries.shape[0]
    chunk = min(chunk, max(k, n))
    dev = queries.device
    best_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for off in range(0, n, chunk):
        scores = queries @ items[off:off + chunk].T          # (B, c), c <= chunk
        width = scores.shape[1]
        if seen_idx is not None:
            local = seen_idx.long() - off                    # (B, S)
            in_chunk = (local >= 0) & (local < width)
            if seen_mask is not None:
                in_chunk &= seen_mask.bool()
            # scatter-min: -inf where a seen entry lands in this chunk, +inf
            # (no-op) elsewhere; padded entries collide harmlessly at 0
            upd = torch.where(in_chunk, NEG_INF, float("inf"))
            scores = scores.scatter_reduce(
                1, local.clamp(0, width - 1), upd, reduce="amin")
        if width < k:        # the JAX chunk's -inf columns past N
            scores = torch.nn.functional.pad(scores, (0, k - width),
                                             value=NEG_INF)
        ch_s, ch_pos = topk_stable(scores, k)
        best_s, best_i = merge_topk(best_s, best_i, ch_s, ch_pos + off, k)
    return best_s, best_i
