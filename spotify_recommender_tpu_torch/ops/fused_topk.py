"""Certified exact retrieval: bf16x2 bin scan + exact rerank + certificate.

The port of the JAX package's certified tier
(spotify_recommender_tpu/ops/pallas/fused_topk.py:787-831, :1273-2063):

    query norms + unit vectors          torch ops
    split into bf16 hi/lo planes        kernel 2 (ops/cuda/split.py)
    v3 bin scan, depth 2 -> top-C       kernel 1 (ops/cuda/scan_v3.py)
    exact fp32 rerank + certificate     torch ops (`rerank_certify`)
    depth-3 rescan of <= 32 failures    kernel 1 again
    oracle for what still fails         ops/similarity.py

Every answer equals the fp32 oracle's: a query whose certificate holds is
provably exact, and every other query is served by the oracle.  On a CUDA
device the kernels run; on the CPU their plain torch versions run.

Differences from the JAX package, each because the JAX code leaned on the
TPU or on XLA (also listed in ROADMAP.md section 3):

- no in-jit fallback capacity, host overflow path or deferred sync: every
  query still failing after the escalation goes to the oracle in one call,
  after one host read of the failure count;
- the rerank keeps the RERANK_ULP gap check always (`bitexact_rerank` held
  only on a TPU);
- `escalations` counts the queries actually rescanned (<= 32 per batch);
- the catalog is stored as 2 planes [hi; lo] (see
  `build_certified_layout`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.config import RetrievalConfig
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.ops import similarity
from spotify_recommender_tpu_torch.ops.cuda.scan_v3 import KERNEL_BINS, scan_v3
from spotify_recommender_tpu_torch.ops.cuda.split import (
    split_bf16x2,
    split_bf16x2_plain,
)
from spotify_recommender_tpu_torch.ops.topk import topk_stable

log = get_logger(__name__)

NEG_INF = float("-inf")
_BIG = 2**62

# BF16X2_EPS — proven bound on |approx_score - exact_score| for the split-
# plane dot, used by the exactness certificate:
#
#   stored value    u~ = hi + lo,  hi = bf16(u), lo = bf16(u - hi)
#                   per-element representation error <= 2^-18 |u|
#                   (two nested round-to-nearest at 2^-9 relative each)
#   prenormalize    u = c / ||c|| in fp32: one rounding, 2^-24 relative,
#                   and the SAME fp32 norms divide the exact tier's dots,
#                   so norm rounding cancels to first order
#   scan dot        bf16 x bf16 products are exact in fp32; the full
#                   product needs all four plane pairs (qh·hi, ql·lo,
#                   ql·hi, qh·lo): 48 rounded fp32 additions in any order
#                   (the CUDA kernel's FMAs round once after an exact
#                   product), accumulation error <= 48 * 2^-24 * 1.01
#                   (Cauchy-Schwarz, unit vectors)
#   exact tier      clip(dot_fp32 / (qn*cn)): its own fp32 error is
#                   <= (F+2) * 2^-24 on the cosine scale
#   clamp & guard   clip contracts differences; the 1e-8 guard uses the
#                   identical fp32 qn*cn product in both tiers
#
#   total: 2 * 2^-18 + 49 * 2^-24 * 1.01 + (12+2+2) * 2^-24  ~= 1.15e-5
#
# 2e-5 carries a ~2x margin; the tests and chip_smoke.py also check the
# bound empirically against the kernel's own output.
BF16X2_EPS = 2e-5

# Rerank and oracle sum their fp32 dots in different orders (a gathered
# batched product against a full matrix product), so a candidate order is
# certified only where adjacent exact scores are separated by more than
# twice this; closer queries go to the oracle.
RERANK_ULP = 1e-6


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class CertifiedLayout:
    """Host-side (numpy) layout of the certified tier, built once per
    catalog.  Field names follow the JAX package's `CertifiedLayout`, so
    `layout_to_device` takes a layout built by either package."""

    w: int                  # scan bin count W
    depth: int              # per-bin candidate depth
    planes: int             # split planes in `ft` (the port builds 2)
    np_pad: int             # padded catalog length (columns of `ft`)
    ft: np.ndarray          # (planes*F, np_pad) fp32 split planes of the
                            # unit rows (bf16 values), pad columns zero
    feats32: np.ndarray     # (rows >= N, F) fp32 row-major catalog
    norms1d: np.ndarray     # (rows,) fp32
    rn_min: float           # min NONZERO norm (the certificate's guard bound)


@dataclasses.dataclass
class DeviceLayout:
    """`CertifiedLayout` as tensors on the device that runs the tier."""

    w: int
    depth: int
    ft: torch.Tensor        # (planes*F, np_pad) bf16
    feats32: torch.Tensor   # (rows, F) fp32
    norms1d: torch.Tensor   # (rows,) fp32
    rn_min: float


def build_certified_layout(
    features: np.ndarray,
    norms: Optional[np.ndarray],
    config: RetrievalConfig,
) -> CertifiedLayout:
    """The certified tier's host-side buffers.

    Padding, bin width and the split are the JAX package's
    (`build_certified_layout`, fused_topk.py:1661), so the bin structures
    of both packages hold the same candidates.  The one choice that
    differs is the planes: the port always stores 2 planes [hi; lo].  The
    JAX package's default 4 planes [hi; lo; hi; lo] feed one 48-deep MXU
    pass on a TPU; on CUDA cores the duplicate planes would only double
    the bytes read, for the same FMAs."""
    feats = np.asarray(features, np.float32)
    n, f = feats.shape
    if norms is None:
        norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    norms = np.asarray(norms, np.float32)
    if config.scan != "v3":
        raise NotImplementedError(
            f"scan={config.scan!r}: only the v3 scan is ported "
            "(ROADMAP queue 1, superseded tiers)"
        )

    tc = min(config.catalog_tile, _round_up(n, 128))
    nw = max(1, config.scan_bins // 128) if config.scan_bins else 1
    if config.scan_bins and config.scan_bins != 128 * nw:
        log.warning(
            "scan_bins=%d is not a multiple of 128; using W=%d",
            config.scan_bins, 128 * nw,
        )
    while nw > 1 and (tc // 128) % nw:
        nw //= 2
        log.warning(
            "scan bin count reduced to W=%d (must divide the catalog "
            "tile's %d lane slices)", 128 * nw, tc // 128,
        )
    # the JAX package pads the catalog to its large small-batch tile too;
    # the same padding keeps the two scans' pad columns identical
    if n >= 65536:
        tc_small = max(tc, min(65536, _round_up(n, 128)))
        if tc_small % tc:
            tc_small = tc
    else:
        tc_small = tc
    np_pad = _round_up(n, max(tc, tc_small))

    unit_rows = feats / np.maximum(norms, 1e-30)[:, None]
    hi, lo = split_bf16x2_plain(torch.from_numpy(unit_rows))
    ft = np.zeros((2 * f, np_pad), np.float32)
    ft[:f, :n] = hi.float().numpy().T
    ft[f:, :n] = lo.float().numpy().T

    nz = norms[norms > 0.0]
    rn_min = float(nz.min()) if nz.size else float(np.finfo(np.float32).max)
    return CertifiedLayout(
        w=128 * nw, depth=config.scan_depth, planes=2, np_pad=np_pad, ft=ft,
        feats32=feats, norms1d=norms, rn_min=rn_min,
    )


def layout_to_device(layout, device: torch.device) -> DeviceLayout:
    """A numpy `CertifiedLayout` (built by this package or by the JAX
    package) as tensors on `device`.  The planes are cast to bf16 on the
    host, which is exact: they hold bf16 values."""
    return DeviceLayout(
        w=int(layout.w),
        depth=int(layout.depth),
        ft=torch.from_numpy(np.ascontiguousarray(layout.ft))
        .to(torch.bfloat16).to(device),
        feats32=torch.from_numpy(np.ascontiguousarray(layout.feats32)).to(device),
        norms1d=torch.from_numpy(np.ascontiguousarray(layout.norms1d)).to(device),
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
    """Exact fp32 rerank of scan candidates + per-query certificate.

    The certificate is `max(a_C, bound) + ceps < s_k`:
      a_C    C-th best approx (bounds the items cut by the top-C),
      bound  best (depth+1)-th value of any bin (bounds items the bins
             dropped),
      s_k    k-th best EXACT score among the reranked candidates.
    If it holds, every non-candidate's exact score is < s_k, so the exact
    top-k is among the candidates.  Scan approx scores bound exact scores
    only for unguarded rows: a row with qn*rn <= eps scores exactly 0
    whatever its cosine, so when such a row can exist for this query
    (qn * rn_min <= eps) the certificate also needs s_k > 0.  Pad columns
    (index >= nvalid) and the excluded row are dropped here, since the scan
    carries no masks.  Returns (top_s (m, k), top_i (m, k), ok (m,))."""
    c = cand.shape[1]
    cand = cand.long()
    # ascending-index candidate order: the stable top-k below then keeps
    # the lowest index on ties, the reference's rule
    order = torch.argsort(torch.where(cand < 0, _BIG, cand), dim=1)
    cand = torch.gather(cand, 1, order)
    safe = cand.clamp(0, dl.feats32.shape[0] - 1)
    rn = dl.norms1d[safe]                                          # (m, C)
    dots = torch.bmm(dl.feats32[safe], queries[:, :, None])[:, :, 0]
    den = qn[:, None] * rn
    guard = den > eps
    ex = torch.where(
        guard, torch.clamp(dots / torch.where(guard, den, 1.0), -1.0, 1.0), 0.0
    )
    bad = (cand < 0) | (cand >= nvalid) | (cand == excl[:, None])
    ex = ex.masked_fill(bad, NEG_INF)
    top_s1, pos = topk_stable(ex, min(k + 1, c))
    top_i = torch.gather(cand, 1, pos)[:, :k]
    top_s = top_s1[:, :k]
    s_k = top_s[:, k - 1]
    ok = torch.maximum(a_s[:, c - 1], cb[:, 0]) + ceps < s_k
    guard_possible = qn * dl.rn_min <= eps
    ok &= ~guard_possible | (s_k > 0.0)
    ok &= (top_s1[:, :-1] - top_s1[:, 1:] > 2.0 * RERANK_ULP).all(dim=1)
    return top_s, top_i, ok


class CertifiedRetriever:
    """Exact top-k by cosine with a per-query proof.

    A bf16x2 split-plane bin scan selects candidates, an exact fp32 rerank
    scores them with the reference's math, and a certificate
    (`rerank_certify`) proves the result equals the full exact retrieval.
    Failing queries are rescanned once at the deeper escalation depth, and
    what still fails is served by the oracle, so the result is always
    exact.  Replaces reference Recommender.cu:184-318 end to end.
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
        """A retriever over a prebuilt numpy layout (from this package or
        the JAX package)."""
        self = cls.__new__(cls)
        self._setup(layout, num_items, feature_dim, config or RetrievalConfig(),
                    device)
        return self

    def _setup(self, layout, n, f, config, device) -> None:
        if device.type == "cuda" and layout.w != KERNEL_BINS:
            raise ValueError(
                f"scan_bins={layout.w}: the CUDA scan supports W={KERNEL_BINS} "
                "only (ROADMAP queue 2, kernel 1)"
            )
        similarity.disable_tf32()
        self.config = config
        self.device = device
        self.num_items = n
        self.feature_dim = f
        self._esc = (
            config.scan_escalate if config.scan_escalate > layout.depth else 0
        )
        self.layout = layout_to_device(layout, device)   # DeviceLayout
        # certificate margin: configurable LOOSER than the proven bound
        # (more fallbacks, never unsound); tighter requests are clamped
        self._ceps = float(max(config.certify_eps, BF16X2_EPS))
        self._large_k_warned = False
        self.fallbacks = 0     # queries served by the oracle
        self.escalations = 0   # queries rescanned at the escalation depth

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

    def _oracle(self, queries, k, excl):
        """Oracle-exact top-k over the real rows; the (m, N) score matrix
        is built whole only while it stays under 1 GB."""
        n = self.num_items
        fn = (
            similarity.exact_topk_iterative
            if queries.shape[0] * n <= 256_000_000
            else similarity.exact_topk_chunked
        )
        return fn(
            queries, self.layout.feats32[:n], self.layout.norms1d[:n],
            exclude_rows=excl, k=k, eps=self.config.eps,
        )

    def _inputs(self, queries, exclude_rows):
        q = torch.atleast_2d(
            torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        ).contiguous()
        if q.shape[1] != self.feature_dim:
            raise ValueError(
                f"query dim {q.shape[1]} != catalog dim {self.feature_dim}"
            )
        if exclude_rows is None:
            excl = torch.full((q.shape[0],), -1, dtype=torch.int64,
                              device=self.device)
        else:
            excl = torch.as_tensor(exclude_rows, device=self.device).long()
        return q, excl

    def __call__(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F) queries -> (scores (B, k) fp32, rows (B, k) int64), on the
        retriever's device."""
        queries, excl = self._inputs(queries, exclude_rows)
        dl = self.layout
        if k > dl.depth * dl.w:
            self._warn_large_k(k)
            return self._oracle(queries, k, excl)
        c = min(max(self.config.prefilter, k), dl.depth * dl.w)
        eps = self.config.eps

        qn = similarity.row_norms(queries)
        qunit = queries / qn.clamp_min(1e-30)[:, None]
        qh, ql = split_bf16x2(qunit)
        # [qh,ql | ql,qh] against [hi;lo]: qh·hi + ql·lo + ql·hi + qh·lo
        q2 = torch.cat([qh, ql, ql, qh], dim=1)
        a_s, cand, cb = scan_v3(q2, dl.ft, w=dl.w, depth=dl.depth, topc=c)
        top_s, top_i, ok = rerank_certify(
            queries, qn, a_s, cand, cb, excl, dl, self.num_items,
            k=k, eps=eps, ceps=self._ceps,
        )
        fail = torch.nonzero(~ok)[:, 0]           # the batch's host sync
        if self._esc and fail.numel():
            # rescan the first <= 32 failing queries once at the deeper
            # depth; splice back only the rows that are now certified
            eidx = fail[:32]
            a2, c2, b2 = scan_v3(q2[eidx], dl.ft, w=dl.w, depth=self._esc,
                                 topc=c)
            ts2, ti2, ok2 = rerank_certify(
                queries[eidx], qn[eidx], a2, c2, b2, excl[eidx], dl,
                self.num_items, k=k, eps=eps, ceps=self._ceps,
            )
            self.escalations += eidx.numel()
            upd = eidx[ok2]
            top_s[upd] = ts2[ok2]
            top_i[upd] = ti2[ok2]
            ok[upd] = True
            fail = torch.nonzero(~ok)[:, 0]
        if fail.numel():
            self.fallbacks += fail.numel()
            fs, fi = self._oracle(queries[fail], k, excl[fail])
            top_s[fail] = fs
            top_i[fail] = fi
        return top_s, top_i

    def retrieve_sync(
        self, queries, k: int, exclude_rows=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`__call__` with the results on the host as numpy arrays."""
        s, i = self(queries, k, exclude_rows)
        return s.cpu().numpy(), i.cpu().numpy()

    def verify_no_overflow(self) -> int:
        """Always 0, kept for API parity with the JAX package: there the
        in-jit oracle fallback had a fixed capacity that could overflow
        under deferred syncs; here every failing query goes to the oracle
        within the call that found it."""
        return 0
