"""Exact retrieval tiers: the fused score + top-k kernel's users, and the
certified tier (bf16x2 bin scan + exact rerank + certificate).

`prepare_and_call`, `FusedRetriever`, `fused_score_topk`, `exact_rerank`
and `PrefilterRetriever` port spotify_recommender_tpu/ops/pallas/
fused_topk.py:415-666: kernel 3 (ops/cuda/fused.py) over a catalog in the
transposed (F, N) layout, stored as fp32 (exact mode, the reference's
division epilogue, or prenormalized rows with `exact_scores=False`), as
bf16, or as bf16x2 split planes (both prenormalized only); and a bf16
prefilter with an exact fp32 rerank.  The JAX package's `_bucket_batch` /
`_batch_inputs` are jit-cache workarounds and have no counterpart here.

The certified tier ports the JAX package's
(spotify_recommender_tpu/ops/pallas/fused_topk.py:787-831, :1273-2063):

    query norms                         torch op (`similarity.row_norms`)
    unit queries, bf16 hi/lo split,     kernel 2, one launch
    the scan's [qh, ql, ql, qh]         (ops/cuda/split.query_prologue)
    bin scan -> top-C                   scan="v3": kernel 1, epilogue-free,
                                        depth 2 (ops/cuda/scan_v3.py);
                                        scan="v2": kernel 4, cosine epilogue
                                        and masks inside, depth 3
                                        (ops/cuda/scan_v2.py)
    exact fp32 rerank + certificate     torch ops (`rerank_certify`)
    depth-3 rescan of <= 32 failures    kernel 1 again (v3 only)
    oracle for what still fails, and    kernel 3, exact fp32, over the
    every query at k > depth x W        rows transposed at set-up

The approx tier (`approx_retrieve`, `ApproxRetriever`; JAX fused_topk.py
:674-784) runs the first three steps alone: no rerank, no certificate, no
fp32 catalog on the device.

Every certified answer equals the fixed-order fp32 oracle's index for
index: the rerank scores with `similarity.fixed_order_dots`, the fallback
oracle with kernel 3 in exact mode, which sums each dot in the same order
with the same roundings and keeps the lowest index first on ties, a query
whose certificate holds is provably exact, and every other query is served
by that oracle.  Against the matrix-product oracle (`similarity.exact_topk`,
cuBLAS on the card), which sums in another order, the scores agree within
1e-6 and the indices wherever neighbouring oracle scores are more than
2e-6 apart.  On a CUDA device the kernels run; on the CPU their plain
torch versions run.

Differences from the JAX package, each because the JAX code leaned on the
TPU or on XLA (also listed in ROADMAP.md section 3):

- no in-jit fallback capacity, host overflow path or deferred sync: every
  query still failing after the escalation goes to the oracle in one call,
  after one host read of the failure count;
- the rerank is bitwise its oracle's on every device (the JAX package's
  `bitexact_rerank` held only on a TPU), so the certificate has no gap
  check;
- `escalations` counts the queries actually rescanned (<= 32 per batch);
- the certified catalog is stored as 2 planes [hi; lo] (see
  `build_certified_layout`), and so is the bf16x2 fused catalog;
- bf16 dots add their exact products in fp32 in one fixed order, so the
  kernel and its plain version agree bitwise (the MXU has its own order);
- the bin scans take any W (a multiple of 128), depth and F on CUDA, as
  the JAX kernels do: W <= 1024 at depth <= 4 on the flat instances where
  the rows fit their tile, else on the wide route (ops/cuda/scan_v3.py
  `scan_route`).  Kernel 3 takes any k, as the JAX kernel does: k <= 128
  on its warp lists, above on its large-k path (ops/cuda/fused.py).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.core.timing import Spans, span
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.cuda.fused import fused_topk
from spotify_recommender_tpu_torch.ops.cuda.scan_v2 import scan_v2
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import scan_v3
from spotify_recommender_tpu_torch.ops.cuda.split import (
    query_prologue,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.topk import topk_stable

log = get_logger(__name__)

NEG_INF = float("-inf")
_BIG = 2**62
FUSED_DTYPES = ("float32", "bfloat16", "bfloat16x2")

# BF16X2_EPS — proven bound on |approx_score - exact_score| for the split-
# plane dot, used by the exactness certificate:
#
#   stored value    u~ = hi + lo,  hi = bf16(u), lo = bf16(u - hi)
#                   per-element representation error <= 2^-17 |u|: for u
#                   in [2^e, 2^(e+1)), |u - hi| <= 2^(e-8), so rounding
#                   u - hi to bf16 errs by <= 2^(e-17).  The bound is
#                   tight (u = 1.0019608 splits with error 2^-17.0), not
#                   the 2^-18 the JAX package's derivation states
#   prenormalize    u = c / ||c|| in fp32: one rounding, 2^-24 relative,
#                   and the SAME fp32 norms divide the exact tier's dots,
#                   so norm rounding cancels to first order
#   scan dot        bf16 x bf16 products are exact in fp32; the full
#                   product needs all four plane pairs (qh·hi, ql·lo,
#                   ql·hi, qh·lo): 48 rounded fp32 additions in any order
#                   (the CUDA kernels' FMAs round once after an exact
#                   product), accumulation error <= 48 * 2^-24 * 1.01
#                   (Cauchy-Schwarz, unit vectors)
#   exact tier      clip(dot_fp32 / (qn*cn)): its own fp32 error is
#                   <= (F+2) * 2^-24 on the cosine scale
#   clamp & guard   clip contracts differences; the 1e-8 guard uses the
#                   identical fp32 qn*cn product in both tiers
#
#   total: 2 * 2^-17 + 49 * 2^-24 * 1.01 + (12+2+2) * 2^-24  ~= 1.91e-5
#
# 2e-5 carries a ~4 % margin; the tests and chip_smoke.py also check the
# bound empirically against the kernels' own output.
BF16X2_EPS = 2e-5

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def query_inputs(
    queries, exclude_rows, device: torch.device, feature_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F) contiguous fp32 queries and (B,) int64 exclusions (-1 =
    none) on `device`, from tensors, arrays or lists."""
    q = torch.atleast_2d(
        torch.as_tensor(queries, dtype=torch.float32, device=device)
    ).contiguous()
    if q.shape[1] != feature_dim:
        raise ValueError(f"query dim {q.shape[1]} != catalog dim {feature_dim}")
    if exclude_rows is None:
        excl = torch.full((q.shape[0],), -1, dtype=torch.int64, device=device)
    else:
        excl = torch.as_tensor(exclude_rows, device=device).long().contiguous()
    return q, excl


def prepare_queries(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qn (B,), q2 (B, 4F) bf16) of (B, F) contiguous fp32 queries: the
    norms the rerank and the oracle read (`similarity.row_norms`) and the
    bin scans' operand, one launch of kernel 2 (`query_prologue`)."""
    qn = similarity.row_norms(queries)
    return qn, query_prologue(queries, qn)


def prepare_and_call(
    queries: torch.Tensor,       # (B, F) fp32 raw queries
    exclude_rows: torch.Tensor,  # (B,) int64, columns of features_t, -1 = none
    features_t: torch.Tensor,    # (F, Np) fp32 or bf16, or (2F, Np) bf16x2
    norms: torch.Tensor,         # (Np,) fp32 raw row norms
    valid: int,                  # columns >= valid are padding
    *,
    k: int,
    eps: float,
    exact: bool,
    dtype: str = "float32",      # the catalog's storage, FUSED_DTYPES
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query norms, prenormalized queries in fast mode, the queries in the
    catalog's storage, then kernel 3 (`_prepare_and_call`,
    fused_topk.py:419).  The kernel always sees the raw norms: its 1e-8
    guard is the reference's in every mode.  bfloat16x2 queries are the
    unit queries' [qh, ql, ql, qh] (kernel 2's prologue), so that storage
    takes `exact=False`, as `FusedRetriever` requires."""
    if dtype == "bfloat16x2":
        if exact:
            raise ValueError("bfloat16x2 queries are prenormalized: "
                             "exact=False")
        # [qh, ql, ql, qh] against [hi; lo]: qh·hi + ql·lo + ql·hi + qh·lo
        qn, queries = prepare_queries(queries.contiguous())
    else:
        qn = similarity.row_norms(queries)
        if not exact:
            # zero-norm queries stay zero: score 0, as the guard gives
            queries = queries / qn.clamp_min(1e-30)[:, None]
        if dtype == "bfloat16":
            queries = queries.to(torch.bfloat16)     # round to nearest even
    return fused_topk(queries.contiguous(), qn, features_t, norms,
                      exclude_rows, valid, k=k, exact=exact, eps=eps)


def _check_fused_config(config: RetrievalConfig) -> None:
    if config.dtype not in FUSED_DTYPES:
        raise ValueError(f"unknown catalog dtype {config.dtype!r}")
    if config.dtype != "float32" and config.exact_scores:
        raise ValueError(
            "bfloat16 catalog storage requires exact_scores=False (bf16 dots "
            "cannot reproduce the reference fp32 math)"
        )


def _host_tensor(arr) -> torch.Tensor:
    """A host array as a tensor, with bf16 arrays (ml_dtypes' bfloat16, as
    `np.asarray` of a JAX array gives) reinterpreted bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


class FusedRetriever:
    """The catalog in kernel 3's layout on the device: transposed (F, N)
    rows with their raw norms (the reference's one-time `initialize` H2D
    copy, Recommender.cu:153-175).

    Storage (`config.dtype`): "float32", raw (`exact_scores=True`) or
    prenormalized; "bfloat16", prenormalized rows rounded to bf16;
    "bfloat16x2", the prenormalized rows' split planes [hi; lo] (2F, N),
    half the JAX package's 4 planes [hi; lo; hi; lo] for the same products.
    bf16 storage requires `exact_scores=False`, as in the JAX package.
    Unlike the TPU layout, the columns are not padded: the CUDA kernel has
    no 128-lane tiles."""

    def __init__(
        self,
        features: np.ndarray,          # (N, F) row-major catalog
        norms: Optional[np.ndarray],
        config: Optional[RetrievalConfig],
        device: torch.device,
    ) -> None:
        config = config or RetrievalConfig()
        _check_fused_config(config)
        feats = np.asarray(features, np.float32)
        if norms is None:
            norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        norms = np.asarray(norms, np.float32)
        if not config.exact_scores:
            # rows prenormalized on the host, exactly as the JAX package
            # does (fused_topk.py:506-509); zero-norm rows stay zero
            feats = feats / np.maximum(norms, 1e-30)[:, None]
        ft = torch.from_numpy(np.array(feats.T, order="C"))
        if config.dtype == "bfloat16":
            ft = ft.to(torch.bfloat16)
        elif config.dtype == "bfloat16x2":
            ft = torch.cat(split_bf16x2_plain(ft), dim=0)
        self._setup(ft, norms, feats.shape[0], config, device)

    @classmethod
    def from_layout(
        cls,
        features_t: np.ndarray,
        norms: np.ndarray,
        num_items: int,
        config: Optional[RetrievalConfig],
        device: torch.device,
    ) -> "FusedRetriever":
        """A retriever over a prebuilt layout and its (Np,) or (1, Np)
        norms, e.g. `np.asarray` of the JAX `FusedRetriever`'s `features_t`
        and `norms` (columns >= num_items are padding): (F, Np) fp32 or
        bf16, or for "bfloat16x2" the (4F, Np) planes [hi; lo; hi; lo], of
        which the retriever keeps [hi; lo]."""
        config = config or RetrievalConfig()
        _check_fused_config(config)
        ft = _host_tensor(features_t)
        if (ft.dtype == torch.float32) != (config.dtype == "float32"):
            raise ValueError(
                f"a {ft.dtype} catalog layout does not match "
                f"dtype={config.dtype!r}"
            )
        if config.dtype == "bfloat16x2":
            if ft.shape[0] % 4:
                raise ValueError(
                    f"a bfloat16x2 layout has 4F rows, got {ft.shape[0]}")
            ft = ft[: ft.shape[0] // 2]
        self = cls.__new__(cls)
        self._setup(ft, np.asarray(norms, np.float32).reshape(-1), num_items,
                    config, device)
        return self

    def _setup(self, features_t, norms, n, config, device) -> None:
        self.config = config
        self.device = device
        self.exact = config.exact_scores
        self.dtype = config.dtype
        self.num_items = int(n)
        planes = 2 if config.dtype == "bfloat16x2" else 1
        self.feature_dim = features_t.shape[0] // planes
        self.features_t = features_t.contiguous().to(device)
        self.norms = torch.from_numpy(np.array(norms, np.float32)).to(device)

    def __call__(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F) queries -> (scores (B, k) fp32, rows (B, k) int64), on the
        retriever's device; unfilled slots are (-inf, -1)."""
        q, excl = query_inputs(queries, exclude_rows, self.device,
                               self.feature_dim)
        return prepare_and_call(
            q, excl, self.features_t, self.norms, self.num_items,
            k=k, eps=self.config.eps, exact=self.exact, dtype=self.dtype,
        )


def fused_score_topk(
    queries,
    features: np.ndarray,
    norms: Optional[np.ndarray] = None,
    *,
    k: int = 10,
    exclude_rows=None,
    config: Optional[RetrievalConfig] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot convenience wrapper (builds the layout per call; hold a
    FusedRetriever for repeated queries against one catalog).  Runs on the
    card unless `device` names the CPU; no card raises."""
    fr = FusedRetriever(np.asarray(features), norms, config,
                        resolve_device(device))
    return fr(queries, k, exclude_rows)


def exact_scores(
    queries: torch.Tensor,   # (m, F) fp32 raw queries
    qn: torch.Tensor,        # (m,) fp32 query norms (similarity.row_norms)
    rows: torch.Tensor,      # (m, C) int64 valid row indices
    feats32: torch.Tensor,   # (rows, F) fp32
    norms1d: torch.Tensor,   # (rows,) fp32
    eps: float,
) -> torch.Tensor:
    """The reference's exact cosine of each query against its own gathered
    rows: clamp(dot / (qn*rn), -1, 1) where qn*rn > eps, else 0.  The dots
    are `similarity.fixed_order_dots`, so each score is bitwise the one the
    certified tier's fixed-order oracle gives the same (query, row)."""
    dots = similarity.fixed_order_dots(queries[:, None, :], feats32[rows])
    den = qn[:, None] * norms1d[rows]
    guard = den > eps
    return torch.where(
        guard, torch.clamp(dots / torch.where(guard, den, 1.0), -1.0, 1.0), 0.0
    )


def exact_rerank(
    queries: torch.Tensor,   # (B, F) fp32 raw queries
    cand: torch.Tensor,      # (B, C) candidate rows, -1 = empty slot
    features: torch.Tensor,  # (N, F) fp32 row-major catalog
    norms: torch.Tensor,     # (N,) fp32
    *,
    k: int,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 rescoring of prefiltered candidates + top-k
    (`_exact_rerank`, fused_topk.py:588).  The top-k runs over the
    candidates in the order given (the prefilter's: approx value
    descending), so on equal exact scores the earlier candidate wins, as
    `lax.top_k` there does."""
    qn = similarity.row_norms(queries)
    cand = cand.long()
    ex = exact_scores(queries, qn, cand.clamp(0, features.shape[0] - 1),
                      features, norms, eps)
    ex = ex.masked_fill(cand < 0, NEG_INF)
    top_s, pos = topk_stable(ex, k)
    return top_s, torch.gather(cand, 1, pos)


class PrefilterRetriever:
    """Two-phase retrieval: a bf16 fused prefilter (kernel 3 over bf16
    storage) to C = max(k, min(prefilter, N)) candidates, then an exact
    fp32 rerank (`PrefilterRetriever`, fused_topk.py:620).

    Not exactness-guaranteed: a true top-k item can fall outside the bf16
    top-C.  The JAX package keeps it for API compatibility (superseded by
    the certified tier).  Any C: above 128 kernel 3 takes its large-k
    path."""

    def __init__(
        self,
        features: np.ndarray,
        norms: Optional[np.ndarray],
        config: Optional[RetrievalConfig],
        device: torch.device,
        prefilter: int = 64,
    ) -> None:
        config = config or RetrievalConfig()
        bf16_cfg = dataclasses.replace(config, dtype="bfloat16",
                                       exact_scores=False)
        feats = np.asarray(features, np.float32)
        if norms is None:
            norms = np.linalg.norm(feats, axis=1).astype(np.float32)
        norms = np.asarray(norms, np.float32)
        similarity.disable_tf32()
        self.device = device
        self.prefilter = min(prefilter, feats.shape[0])
        self.eps = config.eps
        self._approx = FusedRetriever(feats, norms, bf16_cfg, device)
        self._features = torch.from_numpy(feats).to(device)
        self._norms = torch.from_numpy(norms).to(device)

    def __call__(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F) queries -> (scores (B, k) fp32, rows (B, k) int64), on the
        retriever's device."""
        q, excl = query_inputs(queries, exclude_rows, self.device,
                               self._features.shape[1])
        _, cand = self._approx(q, max(k, self.prefilter), excl)
        return exact_rerank(q, cand, self._features, self._norms, k=k,
                            eps=self.eps)


@dataclasses.dataclass
class CertifiedLayout:
    """Host-side (numpy) layout of the certified tier, built once per
    catalog.  Field names follow the JAX package's `CertifiedLayout`, so
    `layout_to_device` takes a layout built by either package."""

    w: int                  # scan bin count W
    depth: int              # per-bin candidate depth (3 for v2)
    scan: str               # "v3" (epilogue-free) or "v2" (epilogue inside)
    planes: int             # split planes in `ft` (the port builds 2)
    np_pad: int             # padded catalog length (columns of `ft`)
    ft: np.ndarray          # (planes*F, np_pad) fp32 split planes of the
                            # unit rows (bf16 values), pad columns zero
    nrm_row: np.ndarray     # (1, np_pad) fp32 raw norms, zero on pad columns
    feats32: np.ndarray     # (rows >= N, F) fp32 row-major catalog
    norms1d: np.ndarray     # (rows,) fp32
    rn_min: float           # min NONZERO norm (the v3 certificate's guard)


@dataclasses.dataclass
class DeviceLayout:
    """`CertifiedLayout` as tensors on the device that runs the tier."""

    w: int
    depth: int
    scan: str
    ft: torch.Tensor        # (planes*F, np_pad) bf16
    nrm_row: torch.Tensor   # (np_pad,) fp32
    feats32: torch.Tensor   # (rows, F) fp32
    norms1d: torch.Tensor   # (rows,) fp32
    rn_min: float


@dataclasses.dataclass
class CertifiedBatch:
    """A certified batch between `CertifiedRetriever.start` and `finish`:
    its inputs and the rerank's answer with each query's certificate
    (`ok` None where the oracle served the whole batch)."""

    queries: torch.Tensor
    excl: torch.Tensor
    k: int
    qn: Optional[torch.Tensor]
    q2: Optional[torch.Tensor]
    top_s: torch.Tensor
    top_i: torch.Tensor
    ok: Optional[torch.Tensor]


def build_certified_layout(
    features: np.ndarray,
    norms: Optional[np.ndarray],
    config: RetrievalConfig,
    *,
    n_shards: int = 1,
) -> CertifiedLayout:
    """The certified tier's host-side buffers.

    Padding, bin width, depth and the split are the JAX package's
    (`build_certified_layout`, fused_topk.py:1661-1778), so the bin
    structures of both packages hold the same candidates: v3 takes
    `scan_depth` and W = `scan_bins` (128 by default), v2 depth 3 and
    W = 512; either W is halved until it divides the catalog tile.  The one
    choice that differs is the planes: the port always stores 2 planes
    [hi; lo].  The JAX package's default 4 planes [hi; lo; hi; lo] feed one
    48-deep MXU pass on a TPU; on CUDA cores the duplicate planes would only
    double the bytes read, for the same FMAs.

    With `n_shards > 1` (parallel/sharding.py) the padded length is a
    multiple of `n_shards` x lcm(tile, 512), so every shard's slice of
    columns is a whole number of tiles (and of W-column groups), and the
    fp32 rows are zero-padded to the same length, so each shard's rows are
    the same slice; the small-batch padding is single-device only."""
    feats = np.asarray(features, np.float32)
    n, f = feats.shape
    if norms is None:
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    norms = np.asarray(norms, np.float32)
    if config.scan not in ("v2", "v3"):
        raise ValueError(f"unknown scan {config.scan!r} (use 'v3' or 'v2')")

    if n_shards > 1:
        tc = min(config.catalog_tile, 128 * max(1, -(-n // (128 * n_shards))))
    else:
        tc = min(config.catalog_tile, _round_up(n, 128))
    if config.scan == "v3":
        nw = max(1, config.scan_bins // 128) if config.scan_bins else 1
        if config.scan_bins and config.scan_bins != 128 * nw:
            log.warning(
                "scan_bins=%d is not a multiple of 128; using W=%d",
                config.scan_bins, 128 * nw,
            )
    else:
        nw = 4
    while nw > 1 and (tc // 128) % nw:
        nw //= 2
        log.warning(
            "scan bin count reduced to W=%d (must divide the catalog "
            "tile's %d lane slices)", 128 * nw, tc // 128,
        )
    if n_shards > 1:
        np_pad = _round_up(n, n_shards * math.lcm(tc, 512))
        rows = np_pad
    else:
        # the JAX package pads the catalog to its large small-batch tile
        # too; the same padding keeps the two scans' pad columns identical
        if n >= 65536:
            tc_small = max(tc, min(65536, _round_up(n, 128)))
            if tc_small % tc:
                tc_small = tc
        else:
            tc_small = tc
        np_pad = _round_up(n, max(tc, tc_small))
        rows = n

    unit_rows = feats / np.maximum(norms, 1e-30)[:, None]
    hi, lo = split_bf16x2_plain(torch.from_numpy(unit_rows))
    ft = np.zeros((2 * f, np_pad), np.float32)
    ft[:f, :n] = hi.float().numpy().T
    ft[f:, :n] = lo.float().numpy().T
    nrm_row = np.zeros((1, np_pad), np.float32)
    nrm_row[0, :n] = norms
    if rows > n:
        feats = np.concatenate([feats, np.zeros((rows - n, f), np.float32)])
        norms = np.concatenate([norms, np.zeros(rows - n, np.float32)])

    nz = norms[norms > 0.0]
    rn_min = float(nz.min()) if nz.size else float(np.finfo(np.float32).max)
    return CertifiedLayout(
        w=128 * nw, depth=config.scan_depth if config.scan == "v3" else 3,
        scan=config.scan, planes=2, np_pad=np_pad, ft=ft, nrm_row=nrm_row,
        feats32=feats, norms1d=norms, rn_min=rn_min,
    )


def _put(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A host array as a tensor of `dtype` on `device` (a copy: `a` may be
    read-only)."""
    return torch.from_numpy(np.array(a)).to(dtype).to(device)


def _put_planes(layout, device: torch.device):
    """The split planes (bf16; the cast on the host is exact, they hold
    bf16 values) and the (Np,) raw norms of a layout, on `device`."""
    return (_put(layout.ft, device, torch.bfloat16),
            _put(np.asarray(layout.nrm_row, np.float32).reshape(-1), device))


def layout_to_device(layout, device: torch.device) -> DeviceLayout:
    """A numpy `CertifiedLayout` (built by this package or by the JAX
    package) as tensors on `device`."""
    ft, nrm_row = _put_planes(layout, device)
    return DeviceLayout(
        w=int(layout.w),
        depth=int(layout.depth),
        scan=str(layout.scan),
        ft=ft,
        nrm_row=nrm_row,
        feats32=_put(layout.feats32, device),
        norms1d=_put(layout.norms1d, device),
        rn_min=float(layout.rn_min),
    )


def rerank_certify(
    queries: torch.Tensor,   # (m, F) fp32 raw queries
    qn: torch.Tensor,        # (m,) fp32 query norms (similarity.row_norms)
    a_s: torch.Tensor,       # (m, C) approx candidate scores, scan order
    cand: torch.Tensor,      # (m, C) candidate columns, scan order
    cb: torch.Tensor,        # (m, 1) coverage bound
    excl: torch.Tensor,      # (m,) excluded rows (-1 = none)
    dl: DeviceLayout,
    nvalid: int,             # true item count
    *,
    k: int,
    eps: float,
    ceps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact fp32 rerank of scan candidates + per-query certificate
    (`_rerank_certify`, fused_topk.py:1273).

    The certificate is `max(a_C, bound) + ceps < s_k`:
      a_C    C-th best approx (bounds the items cut by the top-C),
      bound  best (depth+1)-th value of any bin (bounds items the bins
             dropped),
      s_k    k-th best EXACT score among the reranked candidates.
    If it holds, every non-candidate's exact score is < s_k, so the exact
    top-k is among the candidates.  The v3 scan's raw dots bound exact
    scores only for unguarded rows: a row with qn*rn <= eps scores exactly
    0 whatever its cosine, so when such a row can exist for this query
    (qn * rn_min <= eps) the v3 certificate also needs s_k > 0.  The v2
    scan applies the exact tier's guard itself and needs no such clause
    (the JAX package passes no `rn_min` for v2).  Pad columns (index >=
    nvalid) and the excluded row are dropped here, since the v3 scan
    carries no masks (the v2 scan never returns them).  The exact scores
    are bitwise the fixed-order oracle's, and both take the lowest index
    first on ties, so a certified top-k is that oracle's index for index
    and needs no gap check.  Returns (top_s (m, k), top_i (m, k), ok
    (m,))."""
    c = cand.shape[1]
    cand = cand.long()
    # ascending-index candidate order: the stable top-k below then keeps
    # the lowest index on ties, the reference's rule
    order = torch.argsort(torch.where(cand < 0, _BIG, cand), dim=1)
    cand = torch.gather(cand, 1, order)
    ex = exact_scores(queries, qn, cand.clamp(0, dl.feats32.shape[0] - 1),
                      dl.feats32, dl.norms1d, eps)
    bad = (cand < 0) | (cand >= nvalid) | (cand == excl[:, None])
    ex = ex.masked_fill(bad, NEG_INF)
    top_s, pos = topk_stable(ex, k)
    top_i = torch.gather(cand, 1, pos)
    s_k = top_s[:, k - 1]
    ok = torch.maximum(a_s[:, c - 1], cb[:, 0]) + ceps < s_k
    if dl.scan == "v3":
        guard_possible = qn * dl.rn_min <= eps
        ok &= ~guard_possible | (s_k > 0.0)
    return top_s, top_i, ok


class CertifiedRetriever:
    """Exact top-k by cosine with a per-query proof.

    A bf16x2 split-plane bin scan selects candidates (the layout's `scan`:
    kernel 1 for "v3", kernel 4 for "v2"), an exact fp32 rerank scores them
    with the reference's math, and a certificate (`rerank_certify`) proves
    the result equals the full exact retrieval.  Under v3, failing queries
    are rescanned once at the deeper escalation depth; what still fails is
    served by the oracle (`_oracle`), as is every query of a batch whose k
    exceeds the scan's depth x W.  The oracle is kernel 3 in exact fp32
    mode over the rows transposed once at set-up.  So the result is always
    exact: index for index the fixed-order fp32 oracle's
    (`similarity.exact_topk_*` with `fixed_order=True`), bitwise, and
    within 1e-6 of the matrix-product oracle's scores; slots that no row
    fills (k at or past the row count) are (-inf, -1).  Replaces reference
    Recommender.cu:184-318 end to end.
    """

    def __init__(
        self,
        features: np.ndarray,
        norms: Optional[np.ndarray],
        config: Optional[RetrievalConfig],
        device: torch.device,
    ) -> None:
        config = config or RetrievalConfig()
        feats = np.asarray(features, np.float32)
        layout = build_certified_layout(feats, norms, config)
        self._setup(layout, feats.shape[0], feats.shape[1], config, device)

    @classmethod
    def from_layout(
        cls,
        layout,
        num_items: int,
        feature_dim: int,
        config: Optional[RetrievalConfig],
        device: torch.device,
    ) -> "CertifiedRetriever":
        """A retriever over a prebuilt layout: numpy (from this package or
        the JAX package), or a `DeviceLayout` already on `device`."""
        self = cls.__new__(cls)
        self._setup(layout, num_items, feature_dim, config or RetrievalConfig(),
                    device)
        return self

    def _setup(self, layout, n, f, config, device) -> None:
        similarity.disable_tf32()
        self.config = config
        self.device = device
        self.num_items = n
        self.feature_dim = f
        # the depth-escalation rescan: v3 only, above the base depth
        # (fused_topk.py:1815-1819)
        self._esc = (
            config.scan_escalate
            if layout.scan == "v3" and config.scan_escalate > layout.depth
            else 0
        )
        self.layout = (layout if isinstance(layout, DeviceLayout)
                       else layout_to_device(layout, device))
        # certificate margin: configurable LOOSER than the proven bound
        # (more fallbacks, never unsound); tighter requests are clamped
        self._ceps = float(max(config.certify_eps, BF16X2_EPS))
        self._large_k_warned = False
        # the oracle's catalog in kernel 3's layout, once: the real rows
        # transposed, (F, n rounded up to 4) so that every feature row
        # starts 16-byte aligned (`fused.copy_width`), pad columns zero
        # with zero norms; the rerank keeps gathering the row-major rows
        dl, n4 = self.layout, _round_up(n, 4)
        self._oracle_ft = dl.feats32.new_zeros((f, n4))
        self._oracle_ft[:, :n] = dl.feats32[:n].t()
        self._oracle_norms = dl.norms1d.new_zeros(n4)
        self._oracle_norms[:n] = dl.norms1d[:n]
        self.fallbacks = 0     # queries served by the oracle after the scan
        self.escalations = 0   # queries rescanned at the escalation depth
        # the counters' lock: a service calls one retriever from threads
        self._count_lock = threading.Lock()
        # the span recorder (core/timing.Spans), None while recording is
        # off: `Retriever.record_spans` sets it
        self.spans: Optional[Spans] = None

    def _warn_large_k(self, k: int) -> None:
        if not self._large_k_warned:
            self._large_k_warned = True
            log.warning(
                "k=%d exceeds the certified scan capacity depth*W=%d; "
                "using the full oracle (slower).  Raise "
                "RetrievalConfig.scan_bins (W) and/or scan_depth to keep "
                "large-k retrievals on the certified tier.",
                k, self.layout.depth * self.layout.w,
            )

    def _topc(self, k: int) -> int:
        """Candidates the scan keeps per query for a top-k."""
        return min(max(self.config.prefilter, k),
                   self.layout.depth * self.layout.w)

    def _oracle(self, queries, k, excl, qn=None):
        """Oracle-exact top-k over the real rows: kernel 3 in exact fp32
        mode, scored as the rerank scores them (`fixed_order_dots`' order
        and roundings, the reference's guard and clamp), the lowest index
        first on ties and (-inf, -1) in the slots no row fills.  `qn`: the
        queries' norms, where the batch already holds them."""
        if qn is None:
            qn = similarity.row_norms(queries)
        return fused_topk(queries, qn, self._oracle_ft, self._oracle_norms,
                          excl, self.num_items, k=k, exact=True,
                          eps=self.config.eps)

    def __call__(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F) queries -> (scores (B, k) fp32, rows (B, k) int64), on the
        retriever's device."""
        return self.finish(self.start(queries, k, exclude_rows))

    def start(self, queries, k: int, exclude_rows=None,
              prepared=None) -> "CertifiedBatch":
        """A batch's work up to its certificate (prologue, scan, rerank),
        issued on the device without reading anything back; `finish`
        reads the failures and serves them.  A sharded catalog starts every
        shard before it finishes any, so the shards of distinct cards
        overlap, and hands each shard the (qn, q2) of `prepare_queries`
        that it made once for the shard's device and queries
        (`prepared`).  With `spans` set, the phases are spans of
        "cert.start" (see `finish`)."""
        sp = self.spans
        with span(sp, "cert.start"):
            with span(sp, "cert.inputs", phase=True):
                queries, excl = query_inputs(queries, exclude_rows,
                                             self.device, self.feature_dim)
            dl = self.layout
            if k > dl.depth * dl.w:
                with span(sp, "cert.oracle", phase=True):
                    self._warn_large_k(k)
                    return CertifiedBatch(queries, excl, k, None, None,
                                          *self._oracle(queries, k, excl),
                                          None)
            with span(sp, "cert.prologue", phase=True):
                c = self._topc(k)
                qn, q2 = (prepare_queries(queries) if prepared is None
                          else prepared)
            with span(sp, "cert.scan", phase=True):
                if dl.scan == "v2":
                    a_s, cand, cb = scan_v2(q2, qn, dl.ft, dl.nrm_row, excl,
                                            self.num_items, w=dl.w,
                                            eps=self.config.eps, topc=c)
                else:
                    a_s, cand, cb = scan_v3(q2, dl.ft, w=dl.w,
                                            depth=dl.depth, topc=c,
                                            ncols=self.num_items)
            with span(sp, "cert.rerank", phase=True):
                top_s, top_i, ok = rerank_certify(
                    queries, qn, a_s, cand, cb, excl, dl, self.num_items,
                    k=k, eps=self.config.eps, ceps=self._ceps,
                )
                return CertifiedBatch(queries, excl, k, qn, q2, top_s, top_i,
                                      ok)

    def finish(self, batch: "CertifiedBatch") -> Tuple[torch.Tensor, torch.Tensor]:
        """The started batch's answer: its failures read on the host (the
        batch's sync), the first <= 32 rescanned at the escalation depth
        (v3), and what still fails served by the oracle.

        With `spans` set (`Retriever.record_spans`), each phase is a span,
        and together they cover the two calls: "cert.start" holds
        "cert.inputs" (queries and exclusions onto the device),
        "cert.prologue" (norms and kernel 2), "cert.scan", "cert.rerank",
        or "cert.oracle" alone for k > depth x W; "cert.finish" holds
        "cert.sync" (each host read of the failures, the wait for the
        device's queued work included), "cert.rescan" and
        "cert.fallback".  No span adds a sync or a launch."""
        sp = self.spans
        with span(sp, "cert.finish"):
            top_s, top_i, ok = batch.top_s, batch.top_i, batch.ok
            if ok is None:                  # k beyond the scan: the oracle's
                return top_s, top_i
            queries, excl, k, qn, q2 = (batch.queries, batch.excl, batch.k,
                                        batch.qn, batch.q2)
            dl, eps, c = self.layout, self.config.eps, self._topc(k)
            with span(sp, "cert.sync", phase=True):
                fail = torch.nonzero(~ok)[:, 0]   # the batch's host sync
            if self._esc and fail.numel():
                # rescan the first <= 32 failing queries once at the deeper
                # depth; splice back only the rows that are now certified
                with span(sp, "cert.rescan", phase=True):
                    eidx = fail[:32]
                    a2, c2, b2 = scan_v3(q2[eidx], dl.ft, w=dl.w,
                                         depth=self._esc, topc=c,
                                         ncols=self.num_items)
                    ts2, ti2, ok2 = rerank_certify(
                        queries[eidx], qn[eidx], a2, c2, b2, excl[eidx], dl,
                        self.num_items, k=k, eps=eps, ceps=self._ceps,
                    )
                    with self._count_lock:
                        self.escalations += eidx.numel()
                    upd = eidx[ok2]
                    top_s[upd] = ts2[ok2]
                    top_i[upd] = ti2[ok2]
                    ok[upd] = True
                with span(sp, "cert.sync", phase=True):
                    fail = torch.nonzero(~ok)[:, 0]
            if fail.numel():
                with span(sp, "cert.fallback", phase=True):
                    with self._count_lock:
                        self.fallbacks += fail.numel()
                    fs, fi = self._oracle(queries[fail], k, excl[fail],
                                          qn[fail])
                    top_s[fail] = fs
                    top_i[fail] = fi
            return top_s, top_i

    def retrieve_sync(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`__call__` with the results on the host as numpy arrays."""
        s, i = self(queries, k, exclude_rows)
        return s.cpu().numpy(), i.cpu().numpy()


def approx_retrieve(
    queries: torch.Tensor,   # (B, F) fp32 raw queries
    excl: torch.Tensor,      # (B,) int64 excluded rows (-1 = none)
    ft: torch.Tensor,        # (2F, Np) bf16 split planes of the unit rows
    nrm_row: torch.Tensor,   # (Np,) fp32 raw norms, zero on pad columns
    nvalid: int,             # true item count
    *,
    k: int,
    c: int,
    w: int,
    depth: int,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k (`_approx_retrieve`, fused_topk.py:678): the
    query prologue (kernel 2), one v3 bin scan of the `nvalid` real columns
    to the top-`c` (kernel 1), then the candidates masked and cut to k; no
    rerank, no certificate.

    Scores are the split-plane cosines, within BF16X2_EPS of the exact
    ones, clipped to [-1, 1].  Three departures from the JAX function, each
    a fault it has (ROADMAP 3d):
    - the layout's pad columns never enter a bin (the JAX scan scores them
      0 on their zero planes, so they crowd out every real row of a query
      whose cosines are all below 0, and leak as pad indices);
    - a candidate with qn * norm <= eps scores 0, the exact tier's guard
      (the JAX tier stores tiny rows as unit vectors and scores them ~1);
    - a slot left without a valid candidate (only where fewer than k rows
      other than the excluded one exist, or the masking after the scan
      starves k) is (-inf, -1), never the excluded row.
    The top-k is stable over the scan's order (value descending, slot
    ascending), as `lax.top_k` there."""
    qn, q2 = prepare_queries(queries)
    a_s, cand, _ = scan_v3(q2, ft, w=w, depth=depth, topc=c, ncols=nvalid)
    cand = cand.long()
    bad = (cand < 0) | (cand >= nvalid) | (cand == excl[:, None])
    guard = qn[:, None] * nrm_row[cand.clamp(0, nrm_row.shape[0] - 1)] <= eps
    a_s = torch.where(bad, NEG_INF,
                      torch.where(guard, 0.0, torch.clamp(a_s, -1.0, 1.0)))
    top_s, pos = topk_stable(a_s, k)
    top_i = torch.gather(cand, 1, pos)
    return top_s, top_i.masked_fill(top_s == NEG_INF, -1)


class ApproxRetriever:
    """Speed tier: kernel 1 alone, without the certified tier's rerank,
    certificate or fp32 catalog (`ApproxRetriever`, fused_topk.py:720).

    The device holds only the split planes [hi; lo] of the unit rows and
    the raw norms (the guard's), about 2/3 of the certified tier's bytes.
    Scores err by at most BF16X2_EPS.  A true top-k item is missed when
    more than `depth` of the top-k share a bin.  The layout's pad columns
    (up to the catalog tile, 48,576 of them at 1M rows) never enter a bin,
    so every slot is filled whenever the catalog has k rows besides the
    excluded one.  The layout is the certified tier's
    (`build_certified_layout`), and so are W and the depth."""

    def __init__(
        self,
        features: np.ndarray,
        norms: Optional[np.ndarray],
        config: Optional[RetrievalConfig],
        device: torch.device,
    ) -> None:
        config = config or RetrievalConfig()
        feats = np.asarray(features, np.float32)
        layout = build_certified_layout(feats, norms, config)
        self.config = config
        self.device = device
        self.num_items, self.feature_dim = feats.shape
        self.w, self.depth = layout.w, layout.depth
        self.ft, self.nrm_row = _put_planes(layout, device)

    def __call__(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F) queries -> (scores (B, k) fp32, rows (B, k) int64), on the
        retriever's device; unfilled slots are (-inf, -1)."""
        q, excl = query_inputs(queries, exclude_rows, self.device,
                               self.feature_dim)
        cap = self.depth * self.w
        if k > cap:
            raise ValueError(
                f"k={k} exceeds the approx scan capacity depth*W={cap}; raise "
                "RetrievalConfig.scan_bins and/or scan_depth (or use the "
                "certified tier, which falls back to the oracle for large k)"
            )
        # a few extra candidates so that the masking after the scan rarely
        # starves k
        c = min(max(k + 8, self.config.prefilter), cap)
        return approx_retrieve(q, excl, self.ft, self.nrm_row, self.num_items,
                               k=k, c=c, w=self.w, depth=self.depth,
                               eps=self.config.eps)
