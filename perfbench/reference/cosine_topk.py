"""The plain reference of exact cosine top-k, and its lower-precision control.

Semantics (those of the recommender this repository serves):

- score(q, x) = clamp(q . x / (|q| |x|), -1, 1) where |q| |x| > 1e-8,
  else 0;
- each query may exclude one catalog row (self-exclusion), -1 = none;
- the top-k are the k best scores, the lowest row first among equal
  scores.

`reference_topk` computes this in float64 from the float32 inputs that the
benchmark made, in blocks of queries, with TF32 off.  `control_topk` is the
same computation in TF32, the precision just below the configuration's
float32: every operand of the dots rounded to 10 explicit mantissa bits
(what a TF32 matrix product does with its inputs), the dots summed in
float32.  It runs the same on the CPU and on the card.

Imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-8


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits, to
    nearest with ties to even (finite inputs)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _cosine(q: torch.Tensor, qn: torch.Tensor, cat: torch.Tensor,
            cn: torch.Tensor) -> torch.Tensor:
    """(b, N) cosine scores of queries q against the catalog, given both
    sides' norms, in the dtype of the inputs."""
    dots = q @ cat.T
    denom = qn[:, None] * cn[None, :]
    guard = denom > EPS
    return torch.where(guard,
                       torch.clamp(dots / torch.where(guard, denom, 1.0),
                                   -1.0, 1.0),
                       torch.zeros((), dtype=dots.dtype, device=dots.device))


def _topk(scores: torch.Tensor, excl: torch.Tensor, k: int):
    """Top-k of (b, N) scores, the excluded column dropped, the lowest
    column first on equal scores (a stable descending sort)."""
    cols = torch.arange(scores.shape[1], device=scores.device)
    scores = scores.masked_fill(cols[None, :] == excl[:, None], float("-inf"))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def reference_topk(catalog: torch.Tensor, queries: torch.Tensor,
                   excl: torch.Tensor, k: int, block: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 exact top-k: (scores (B, k) float64, rows (B, k) int64) on
    the catalog's device.  `catalog` (N, F) and `queries` (B, F) are the
    float32 inputs; `excl` (B,) the excluded rows."""
    _no_tf32()
    cat = catalog.to(torch.float64)
    cn = torch.linalg.vector_norm(cat, dim=1)
    q = queries.to(device=cat.device, dtype=torch.float64)
    qn = torch.linalg.vector_norm(q, dim=1)
    excl = excl.to(device=cat.device, dtype=torch.int64)
    out_s, out_i = [], []
    for s in range(0, q.shape[0], block):
        v, i = _topk(_cosine(q[s:s + block], qn[s:s + block], cat, cn),
                     excl[s:s + block], k)
        out_s.append(v)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def reference_scores(catalog: torch.Tensor, queries: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """float64 scores (B, k) of the given rows (B, k) for each query; rows
    must lie in [0, N)."""
    _no_tf32()
    cat = catalog.to(torch.float64)
    q = queries.to(device=cat.device, dtype=torch.float64)
    x = cat[rows.to(cat.device)]                           # (B, k, F)
    dots = (x * q[:, None, :]).sum(-1)
    denom = (torch.linalg.vector_norm(q, dim=1)[:, None]
             * torch.linalg.vector_norm(x, dim=2))
    guard = denom > EPS
    return torch.where(guard,
                       torch.clamp(dots / torch.where(guard, denom, 1.0),
                                   -1.0, 1.0),
                       torch.zeros((), dtype=dots.dtype, device=dots.device))


def control_topk(catalog: torch.Tensor, queries: torch.Tensor,
                 excl: torch.Tensor, k: int, block: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference in TF32: operands rounded to TF32, dots and cosines in
    float32 with TF32 off (so the rounding is this function's own and the
    same on every device), norms in float32 from the unrounded rows.
    Returns (scores (B, k) float32, rows (B, k) int64)."""
    _no_tf32()
    cat = catalog.to(torch.float32)
    cn = torch.linalg.vector_norm(cat, dim=1)
    q = queries.to(device=cat.device, dtype=torch.float32)
    qn = torch.linalg.vector_norm(q, dim=1)
    cat_t, q_t = round_tf32(cat), round_tf32(q)
    excl = excl.to(device=cat.device, dtype=torch.int64)
    out_s, out_i = [], []
    for s in range(0, q.shape[0], block):
        v, i = _topk(_cosine(q_t[s:s + block], qn[s:s + block], cat_t, cn),
                     excl[s:s + block], k)
        out_s.append(v)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)
